"""Single-lane sigma-embedding encoder (CKKS-style, power-of-5 Vandermonde).

Counterpart of matrix_fhe_tpu/models/encoder.py.  A 64x64 complex message
is mapped to XY-coefficient space by V^-1 M V^-T (encoder.cu:329-501).  The
port runs the JAX package's words-chained route: both halves of each
sandwich are exact fixed-point matmuls (kernel K4) linked by exact
integer shift-rounds, the encode quantize works on the words (Delta a
power of two; any other Delta is quantized by `quantize`, llround(c Delta)
mod q, after `idft2_exact`), and decode reconstructs f64 once at the end.  The Delta^2 decode of homomorphic
products uses the exact big-int dequantize and `dft2_exact`, the sandwich
with an f64 reconstruction after each K4 half (the JAX route with the
fixed-point transforms on); the gl2 encode uses its inverse twin
`idft2_exact`.  The f64 `idft2` / `dft2` are the plain complex128
sandwiches, kept for tests.  The reference's per-lane `encode` and
`decode_lane_from_rns_eval` run the fixed-point sandwiches (K4) with the
llround quantize and the exact dequantize.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from ..config import GLParams
from ..ops.crt import CRTComposer
from ..ops.ddfloat import words_shr_round
from ..ops.fpmatmul import ExactComplexMatmul
from ..ops.modmath import moduli_col
from ..tables import GLTables, build_tables
from .rng import llround

F64 = torch.float64


def _perm_words(words, f):
    return tuple(f(w) for w in words)


class Encoder:
    """sigma-embedding over a batch of n x n complex matrices [W, n, n]."""

    def __init__(self, params: GLParams, tables: GLTables | None = None, *,
                 device):
        t = tables or build_tables(params)
        self.params = params
        self._fp_v = ExactComplexMatmul(t.enc_v, device)
        self._fp_vi = ExactComplexMatmul(t.enc_v_inv, device)
        self._v = torch.from_numpy(t.enc_v).to(device)
        self._vi = torch.from_numpy(t.enc_v_inv).to(device)
        self._composer = CRTComposer(t)

    # -- words-chained transforms ------------------------------------------

    @staticmethod
    def _sandwich_words_tail(fp, wr, wi, e1, W, n):
        """Second half of a V (..) V^T sandwich on the words of the first:
        lane reorder (W, j) -> (W, i'), chained matmul, [W, n, n] reorder."""
        def perm1(x):
            return x.reshape(n, W, n).permute(2, 1, 0).reshape(n, -1)

        ur, ui, e2 = fp.call_words_w(_perm_words(wr, perm1),
                                     _perm_words(wi, perm1), e1)

        def perm2(x):
            return x.reshape(n, W, n).permute(1, 2, 0)

        return _perm_words(ur, perm2), _perm_words(ui, perm2), e2

    def idft2_words(self, m_re: torch.Tensor, m_im: torch.Tensor):
        """V^-1 M V^-T of [W, n, n] f64 messages as words ([W, n, n]
        planes) and their scale."""
        W, n = m_re.shape[0], m_re.shape[-1]
        mr = m_re.to(F64).transpose(0, 1).reshape(n, -1)
        mi = m_im.to(F64).transpose(0, 1).reshape(n, -1)
        wr, wi, e1 = self._fp_vi.call_words(mr, mi)
        return self._sandwich_words_tail(self._fp_vi, wr, wi, e1, W, n)

    def dft2_words_in(self, words_r, words_i, e_scale):
        """V E V^T of words ([W, n, n] planes) -> the final f64 pair."""
        fp = self._fp_v
        W, n = words_r[0].shape[0], words_r[0].shape[-1]

        def perm0(x):
            return x.transpose(0, 1).reshape(n, -1)

        ur, ui, e1 = fp.call_words_w(_perm_words(words_r, perm0),
                                     _perm_words(words_i, perm0), e_scale)
        ur, ui, e2 = self._sandwich_words_tail(fp, ur, ui, e1, W, n)
        return (ExactComplexMatmul.words_to_f64(ur, e2),
                ExactComplexMatmul.words_to_f64(ui, e2))

    def dft2_exact(self, e_re: torch.Tensor, e_im: torch.Tensor
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
        """V E V^T of an f64 pair [W, n, n], each half an exact fixed-point
        matmul (K4) reconstructed to f64 (the JAX _sandwich with fp)."""
        return self._sandwich_exact(self._fp_v, e_re, e_im)

    def idft2_exact(self, m_re: torch.Tensor, m_im: torch.Tensor
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """V^-1 M V^-T of an f64 pair [W, n, n], each half an exact
        fixed-point matmul (K4) reconstructed to f64: the JAX Encoder.idft2
        with the fixed-point transforms on (encoder.py:72-98 there)."""
        return self._sandwich_exact(self._fp_vi, m_re, m_im)

    @staticmethod
    def _sandwich_exact(fp, e_re, e_im):
        W, n = e_re.shape[0], e_re.shape[-1]
        mr = e_re.to(F64).transpose(0, 1).reshape(n, -1)
        mi = e_im.to(F64).transpose(0, 1).reshape(n, -1)
        tr, ti = fp(mr, mi)                               # [n(i'), W*n(j)]
        sr = tr.reshape(n, W, n).permute(2, 1, 0).reshape(n, -1)
        si = ti.reshape(n, W, n).permute(2, 1, 0).reshape(n, -1)
        ur, ui = fp(sr, si)                               # [n(j'), W*n(i')]
        return (ur.reshape(n, W, n).permute(1, 2, 0),
                ui.reshape(n, W, n).permute(1, 2, 0))

    # -- f64 reference sandwiches (tests) ----------------------------------

    def idft2(self, m_re, m_im) -> Tuple[torch.Tensor, torch.Tensor]:
        """V^-1 @ M @ (V^-1)^T in complex128 (encoder.cu:460-467)."""
        m = torch.complex(m_re.to(F64), m_im.to(F64))
        out = self._vi @ m @ self._vi.T
        return out.real, out.imag

    def dft2(self, e_re, e_im) -> Tuple[torch.Tensor, torch.Tensor]:
        """V @ E @ V^T in complex128 (encoder.cu:492-501)."""
        e = torch.complex(e_re.to(F64), e_im.to(F64))
        out = self._v @ e @ self._v.T
        return out.real, out.imag

    # -- quantize ------------------------------------------------------------

    @property
    def words_route(self) -> bool:
        """True when Delta is a power of two, so that the quantize is an
        exact shift of the fixed-point words (quantize_words)."""
        d = float(self.params.delta)
        return 2.0 ** round(np.log2(d)) == d

    @property
    def delta_bits(self) -> int:
        if not self.words_route:
            raise ValueError("the words route needs a power-of-two Delta")
        return int(round(np.log2(float(self.params.delta))))

    def quantize(self, c_re: torch.Tensor, c_im: torch.Tensor
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
        """llround(c * Delta) split into RNS limbs: f64 [...] -> int64
        residues [L, ...] for re and im (Encoder.quantize there,
        quantize_soa_kernel, encoder.cu:36-50), for any Delta; exact while
        |c * Delta| < 2^52."""
        delta = float(self.params.delta)
        outs = []
        for c in (c_re, c_im):
            v = llround(c * delta)
            outs.append(v[None] % moduli_col(self.params.moduli, v.dim(),
                                             v.device))
        return outs[0], outs[1]

    def quantize_words(self, words_re, words_im, e_scale):
        """round(c * Delta) split into RNS limbs straight from the words:
        an exact right shift by e_scale - log2(Delta), then +-v mod q per
        limb.  Returns int64 residues [L, ...] for re and im."""
        diff = e_scale - self.delta_bits
        if int(diff) < 1:
            raise ValueError(
                "quantize_words: message magnitude exceeds the encode "
                f"contract (e_scale={int(e_scale)} <= "
                f"delta_bits={self.delta_bits}); residues would be "
                "mis-scaled")
        outs = []
        for m0, m1, m2, sg in (words_re, words_im):
            lo, hi = words_shr_round(m0, m1, m2, diff)
            v = lo | (hi << 32)
            q = moduli_col(self.params.moduli, v.dim(), v.device)
            r = v % q
            outs.append(torch.where((sg == 1) & (r != 0), q - r, r))
        return outs[0], outs[1]

    # -- the reference's per-lane encode and decode ------------------------

    def encode(self, m_re: torch.Tensor, m_im: torch.Tensor
               ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Full lane encode: complex matrices [..., n, n] -> RNS residues
        [L, ..., n, n] in the XY-eval basis (Encoder::encode,
        encoder.cu:446-458): the sandwich V^-1 M V^-T as exact fixed-point
        matmuls (K4, idft2_exact), then llround(c Delta) mod q."""
        cr, ci = self._lanes(self.idft2_exact, m_re, m_im)
        return self.quantize(cr, ci)

    def decode_lane_from_rns_eval(self, rns_re: torch.Tensor,
                                  rns_im: torch.Tensor
                                  ) -> Tuple[torch.Tensor, torch.Tensor]:
        """encoder.cu:470-490: exact dequantize, then V E V^T as exact
        fixed-point matmuls (K4, dft2_exact); [L, ..., n, n] residues ->
        f64 pair [..., n, n]."""
        er, ei = self.dequantize_exact(rns_re, rns_im)
        return self._lanes(self.dft2_exact, er, ei)

    @staticmethod
    def _lanes(sandwich, x_re, x_im):
        """A [W, n, n] sandwich on [..., n, n]: leading dims as the lanes."""
        shape = x_re.shape
        n = shape[-1]
        yr, yi = sandwich(x_re.reshape(-1, n, n), x_im.reshape(-1, n, n))
        return yr.reshape(shape), yi.reshape(shape)

    # -- exact dequantize ----------------------------------------------------

    def dequantize_exact(self, rns_re, rns_im):
        """Exact big-int CRT -> f64 / Delta (dequantize_exact_kernel,
        encoder.cu:112-150); inputs [L, ..., n, n]."""
        return self.dequantize_exact_delta(rns_re, rns_im, self.params.delta)

    def dequantize_exact_delta(self, rns_re, rns_im, delta):
        """dequantize_exact with an explicit scale (e.g. Delta^2 for
        un-rescaled homomorphic products)."""
        return (self._composer.compose_to_float(rns_re, delta),
                self._composer.compose_to_float(rns_im, delta))
