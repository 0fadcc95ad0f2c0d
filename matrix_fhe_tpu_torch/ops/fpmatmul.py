"""Kernel K4: exact fixed-point complex matmul Y = T @ X.

Counterpart of matrix_fhe_tpu/ops/fpmatmul.py (ExactComplexMatmul).  The
function is the JAX one: the table is quantized once on the host to
t_int = round(T * 2^t_bits) (the same numpy code, so the same integers),
the input is scaled by a dynamic power of two to |x_int| <= 2^X_BITS and
rounded half-to-even, and the kernel forms the exact integer sums
sum_k t_int * x_int and returns them as sign plus 96-bit magnitude words
(m0, m1, m2, sg), each an int64 tensor holding a u32 value, with

    value = (-1)^sg * (m0 + m1 2^32 + m2 2^64) * 2^-e_scale.

The scaling and the renormalization between chained calls run in plain
torch around the kernel.  Powers of two are built from their bits
(ddfloat.pow2), so every scale is exact on every device.

On the card the sums are balanced s8 digit-plane GEMMs on the int8 tensor
cores (csrc/fp_cmatmul.cu): the table's digit planes are cut once
(``table_planes``, at an ExactComplexMatmul's first CUDA call), the data's
by a split pass (launch key "fp_cmatmul_split") before the GEMM (launch key
"fp_cmatmul").
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import numpy as np
import torch

from . import _backend as be
from .ddfloat import pow2, words_shr_round

X_BITS = 37           # |x_int| <= 2^X_BITS (matrix_fhe_tpu default)
T_DIGITS = 5          # the JAX kernel's balanced-digit table range
K4_DIGITS = 5         # K4's balanced 8-bit digits of every operand (< 2^39)
F64 = torch.float64
I64 = torch.int64
Words = Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]

_DIGIT = 16
_DMASK = (1 << _DIGIT) - 1


def _signed_digits(x: torch.Tensor, count: int):
    """x = sum_i d_i 2^(16 i): digits in [0, 2^16) except the top one,
    which carries the sign (arithmetic shift)."""
    out = []
    for i in range(count):
        d = x >> (_DIGIT * i)
        out.append((d if i == count - 1 else d & _DMASK).to(F64))
    return out


def _words_from_diagonals(diags) -> Words:
    """Exact sum_s diags[s] 2^(16 s) (int64 diagonals, |d| < 2^50) as sign
    and 96-bit magnitude words."""
    def digits_of(sign):
        carry = torch.zeros_like(diags[0])
        ds = []
        for s in range(8):          # 128 bits in 16-bit digits
            v = carry + (sign * diags[s] if s < len(diags) else 0)
            ds.append(v & _DMASK)
            carry = v >> _DIGIT
        return ds, carry            # carry: 0 or -1 (the 2^128 place)

    pos, top = digits_of(1)
    neg, _ = digits_of(-1)
    sg = (top < 0).to(I64)
    mag = [torch.where(sg == 1, n, p) for p, n in zip(pos, neg)]
    m0 = mag[0] | (mag[1] << 16)
    m1 = mag[2] | (mag[3] << 16)
    m2 = mag[4] | (mag[5] << 16)
    return m0, m1, m2, sg


def fp_cmatmul_plain(tr, ti, xr, xi) -> Tuple[Words, Words]:
    """Plain K4: exact complex integer product from float64 matmuls over
    16-bit digits (|t_int| < 2^35, |x_int| < 2^47, K < 2^11 keep every
    float64 sum below 2^53)."""
    if tr.shape[1] >= 1 << 11:
        raise ValueError("contraction too long for exact float64 digit sums")
    trd, tid = _signed_digits(tr, 3), _signed_digits(ti, 3)
    xrd, xid = _signed_digits(xr, 3), _signed_digits(xi, 3)
    re = [None] * 5
    im = [None] * 5
    for i in range(3):
        for j in range(3):
            pr = trd[i] @ xrd[j] - tid[i] @ xid[j]
            pi = trd[i] @ xid[j] + tid[i] @ xrd[j]
            s = i + j
            re[s] = pr if re[s] is None else re[s] + pr
            im[s] = pi if im[s] is None else im[s] + pi
    return (_words_from_diagonals([d.to(I64) for d in re]),
            _words_from_diagonals([d.to(I64) for d in im]))


def plane_layout(w: int, k: int) -> Tuple[int, int, int, int]:
    """(Wp, Kp, digits, most K) of K4's digit planes for a [w, k] table, as
    csrc/fp_cmatmul.cu lays them out (mf_fp_layout): table planes
    [3, digits, Wp, Kp], data planes [2, digits, M, Kp] s8."""
    layout = (ctypes.c_int * 4)()
    be.library().mf_fp_layout(w, k, layout)
    return tuple(layout)


def balanced_digits(v: torch.Tensor, count: int = K4_DIGITS):
    """v = sum_j d_j 2^(8 j) with every d_j in [-128, 127] (int64 tensors),
    as K4 cuts its operands; raises if v needs more than `count` digits."""
    out = []
    for _ in range(count):
        d = ((v + 128) & 255) - 128
        out.append(d)
        v = (v - d) >> 8
    if bool((v != 0).any()):
        raise ValueError(f"values outside {count} balanced 8-bit digits")
    return out


def table_planes(tr: torch.Tensor, ti: torch.Tensor, wp: int,
                 kp: int) -> torch.Tensor:
    """K4's table planes, s8 [3, K4_DIGITS, wp, kp] on the table's device:
    the balanced digits of tr, ti and -ti, zero past [W, K]."""
    W, K = tr.shape
    planes = torch.zeros((3, K4_DIGITS, wp, kp), dtype=torch.int8,
                         device=tr.device)
    for c, t in enumerate((tr, ti, -ti)):
        for j, d in enumerate(balanced_digits(t)):
            planes[c, j, :W, :K] = d.to(torch.int8)
    return planes


def fp_cmatmul_kernel(tr, ti, xr, xi, planes=None) -> Tuple[Words, Words]:
    """K4 on the card: `planes` are the table's (table_planes at
    plane_layout's pads, cut here when not given).

    The domain is the JAX kernel's, which ExactComplexMatmul keeps by
    construction: |x| <= 2^X_BITS (2^37, the value 2^37 itself included,
    which call_words_w's shift-round can give) and
    max(|tr|, |ti|, |tr + ti|) <= 127 128^4 / 2, with K <= 13,107 (the s32
    diagonal sums stay exact).  The kernel is exact for any |x|, |t| < 2^39
    (five balanced 8-bit digits); the data is not checked on the card, the
    table's digits are when they are cut.  The CPU route
    (fp_cmatmul_plain) takes |t| < 2^35, |x| < 2^47, K < 2^11."""
    W, K = tr.shape
    M = xr.shape[1]
    be.check(tr, "tr", I64, (W, K))
    be.check(ti, "ti", I64, (W, K))
    be.check(xr, "xr", I64, (K, M))
    be.check(xi, "xi", I64, (K, M))
    wp, kp, digits, max_k = plane_layout(W, K)
    if K > max_k:
        raise ValueError(f"contraction of {K} terms exceeds K4's {max_k}")
    if planes is None:
        planes = table_planes(tr, ti, wp, kp)
    be.check(planes, "planes", torch.int8, (3, digits, wp, kp))
    xp = torch.empty((2, digits, M, kp), dtype=torch.int8, device=xr.device)
    be.launch("fp_cmatmul_split", "mf_fp_split", xr.device, xr, xi, xp, K,
              M, kp)
    out = torch.empty((2, 4, W, M), dtype=I64, device=xr.device)
    be.launch("fp_cmatmul", "mf_fp_cmatmul", xr.device, planes, xp, out, W,
              M, wp, kp)
    return tuple(out[0].unbind(0)), tuple(out[1].unbind(0))


def fp_cmatmul(tr, ti, xr, xi, planes=None) -> Tuple[Words, Words]:
    """Exact words of (tr + i ti) @ (xr + i xi): the kernel on CUDA
    tensors (with the table's planes, if given), the plain version on CPU
    tensors."""
    if be.on_device(tr, ti, xr, xi):
        return fp_cmatmul_kernel(tr, ti, xr, xi, planes)
    return fp_cmatmul_plain(tr, ti, xr, xi)


class ExactComplexMatmul:
    """Y = T @ X exact fixed-point complex matmul; T [W, K] complex128
    (host), X [K, M] f64 re/im pair on `device`."""

    def __init__(self, t_complex: np.ndarray, device):
        W, K = t_complex.shape
        self.w, self.k = W, K
        bound = 127 * (128 ** (T_DIGITS - 1)) // 2
        mx = max(np.abs(t_complex.real).max(), np.abs(t_complex.imag).max(),
                 np.abs(t_complex.real + t_complex.imag).max())
        self.t_bits = int(np.floor(np.log2(bound / max(mx, 1e-300))))
        scale = 2.0 ** self.t_bits
        self.tr = torch.from_numpy(
            np.round(t_complex.real * scale).astype(np.int64)).to(device)
        self.ti = torch.from_numpy(
            np.round(t_complex.imag * scale).astype(np.int64)).to(device)
        self._planes = None           # K4's table planes, at the first CUDA call

    def planes(self) -> torch.Tensor:
        """The table's digit planes for the card, cut once."""
        if self._planes is None:
            self._planes = table_planes(self.tr, self.ti,
                                        *plane_layout(self.w, self.k)[:2])
        return self._planes

    def _matmul(self, xr_int, xi_int):
        planes = self.planes() if self.tr.is_cuda else None
        return fp_cmatmul(self.tr, self.ti, xr_int.contiguous(),
                          xi_int.contiguous(), planes)

    def call_words(self, xr: torch.Tensor, xi: torch.Tensor):
        """((m0, m1, m2, sg) re, (..) im, e_scale) with e_scale an int64
        scalar tensor."""
        mx = torch.maximum(xr.abs().max(), xi.abs().max()).clamp_min(1e-300)
        e_pow = X_BITS - torch.ceil(torch.log2(mx))
        s = pow2(e_pow)
        vr = torch.round(xr * s).to(I64)
        vi = torch.round(xi * s).to(I64)
        words_re, words_im = self._matmul(vr, vi)
        return words_re, words_im, e_pow.to(I64) + self.t_bits

    def call_words_w(self, words_re: Words, words_im: Words,
                     e_scale: torch.Tensor):
        """Chain entry: renormalize another call's words to <= 2^X_BITS by
        an exact shift-round (the shift from the word maxima) and multiply."""
        def ceiling(w):
            v = (w[0].max().to(F64) + w[1].max().to(F64) * 2.0 ** 32
                 + w[2].max().to(F64) * 2.0 ** 64)
            return v.clamp_min(1.0)

        mx = torch.maximum(ceiling(words_re), ceiling(words_im))
        sh = (torch.ceil(torch.log2(mx)).to(I64) - X_BITS).clamp_min(0)

        def renorm(m0, m1, m2, sg):
            lo, hi = words_shr_round(m0, m1, m2, sh)
            mag = lo | (hi << 32)
            return torch.where(sg == 1, -mag, mag)

        words_re2, words_im2 = self._matmul(renorm(*words_re),
                                            renorm(*words_im))
        return words_re2, words_im2, e_scale - sh + self.t_bits

    @staticmethod
    def words_to_f64(words: Words, e_scale: torch.Tensor) -> torch.Tensor:
        m0, m1, m2, sg = words
        v = m0.to(F64) + m1.to(F64) * 2.0 ** 32 + m2.to(F64) * 2.0 ** 64
        return torch.where(sg == 1, -v, v) * pow2(-e_scale)

    def __call__(self, xr: torch.Tensor, xi: torch.Tensor
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
        """T @ (xr + i xi) reconstructed to f64
        (matrix_fhe_tpu/ops/fpmatmul.py:370-374)."""
        words_re, words_im, e_scale = self.call_words(xr, xi)
        return (self.words_to_f64(words_re, e_scale),
                self.words_to_f64(words_im, e_scale))
