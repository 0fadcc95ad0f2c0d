"""Ciphertext-level homomorphic matrix multiplication via the field trace.

Counterpart of matrix_fhe_tpu/models/he_matmul.py, which derives the
scheme (the Galois lane flip, the post-map PM commuted through the GEMM,
the Delta^2 scale divided out at decode):

    C = PM(E0 + E1R (*) flip(s)) + PM(E1L + E2 (*) flip(s)) (*) s

with E0 = G(bA, cFL(bB)), E1R = G(bA, cFL(aB)), E1L = G(aA, cFL(bB)),
E2 = G(aA, cFL(aB)), G the n-scaled complex modular GEMM (trace_gemm,
kernel K6), cFL = conj(flip(.)) and (*) the GL ring product along the named
output axis (kernel K2).  Decryption decodes the Delta^2-scaled result with
the exact big-int compose.  ring="gl" contexts only (X^n = i).

Memory: the tensor is eight [L, W, n, n] int64 planes (1.48 GB at ref);
the transposes and lane gathers below are copied to contiguous operands
before each kernel call (185 MB a plane at ref).
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import numpy as np
import torch

from ..config import GLParams
from ..ops import modmath as mm
from ..ops.ntt import RING_GL
from ..utils.profiler import span
from . import trace as tr
from .he import Ciphertext, HEContext, SecretKey


class MatmulTensor(NamedTuple):
    """Raw homomorphic-GEMM tensor (transposed per-lane frame: axis -2 = the
    left operand's X axis, axis -1 = the right operand's X axis)."""
    e0_re: torch.Tensor
    e0_im: torch.Tensor
    e1l_re: torch.Tensor
    e1l_im: torch.Tensor
    e1r_re: torch.Tensor
    e1r_im: torch.Tensor
    e2_re: torch.Tensor
    e2_im: torch.Tensor


def conj_flip_perm(params: GLParams) -> np.ndarray:
    """Lane permutation of the W-axis Galois conjugation:
    exp[flip(w)] == -exp[w] (mod p)."""
    exps = np.asarray(params.w_exponents)
    flip = np.empty(len(exps), dtype=np.int64)
    for w, e in enumerate(exps):
        (idx,) = np.nonzero(exps == (-int(e)) % params.p)
        flip[w] = idx[0]
    return flip


def _t(x: torch.Tensor) -> torch.Tensor:
    return x.transpose(-1, -2)


class HEMatmul:
    """Homomorphic C = Y^H @ X on packed n x n lanes (ring="gl" contexts)."""

    def __init__(self, ctx: HEContext):
        if ctx.ring != RING_GL:
            raise ValueError("trace matmul requires a ring='gl' HEContext "
                             "(X^n = i; Theorems 3.8/3.9)")
        self.ctx = ctx
        self.params = ctx.params
        dev, n = ctx.device, ctx.params.n
        self._flip = torch.from_numpy(conj_flip_perm(ctx.params)).to(dev)
        self._negk = torch.from_numpy((-np.arange(n)) % n).to(dev)
        self._col0 = torch.arange(n, device=dev) == 0

    # -- building blocks -------------------------------------------------------

    def _cfl(self, re, im):
        """conj(flip(.)): W-lane flip + pair conjugation (multiplicative)."""
        fr = re.index_select(1, self._flip)
        fi = im.index_select(1, self._flip)
        return fr, mm.neg_mod(fi, self.ctx._q4)

    def _postmap(self, re, im):
        """PM: output column k -> -k mod n, x(-i) on columns k != 0."""
        a = re.index_select(-1, self._negk)
        b = im.index_select(-1, self._negk)
        # -i * (a + ib) = b - ia on k != 0; identity on k == 0
        return (torch.where(self._col0, a, b),
                torch.where(self._col0, b, mm.neg_mod(a, self.ctx._q4)))

    def _mul_s_cols(self, re, im, s_mont):
        """GL ring product by a real key along axis -1 (kernel K2)."""
        return (self.ctx.xntt.mul_s(re, s_mont),
                self.ctx.xntt.mul_s(im, s_mont))

    def _mul_s_rows(self, re, im, s_mont):
        r = self.ctx.xntt.mul_s(_t(re), s_mont)
        i = self.ctx.xntt.mul_s(_t(im), s_mont)
        return _t(r), _t(i)

    # -- the op ------------------------------------------------------------------

    def tensor_fn(self, ctX_re: Ciphertext, ctX_im: Ciphertext,
                  ctY_re: Ciphertext, ctY_im: Ciphertext) -> MatmulTensor:
        """The secret-key-free half: four n-scaled complex modular GEMMs of
        the X components against conj(flip(Y)) components."""
        p = self.params
        bX = (_t(ctX_re.b), _t(ctX_im.b))
        aX = (_t(ctX_re.a), _t(ctX_im.a))
        bY = self._cfl(_t(ctY_re.b), _t(ctY_im.b))
        aY = self._cfl(_t(ctY_re.a), _t(ctY_im.a))
        e0 = tr.trace_gemm(*bX, *bY, p)
        e1l = tr.trace_gemm(*aX, *bY, p)
        e1r = tr.trace_gemm(*bX, *aY, p)
        e2 = tr.trace_gemm(*aX, *aY, p)
        return MatmulTensor(*e0, *e1l, *e1r, *e2)

    def decrypt_fn(self, tt: MatmulTensor, sk: SecretKey
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
        """C = PM(E0 + E1R*flip(s)) + PM(E1L + E2*flip(s))*s, returned in
        ciphertext orientation, W-eval / XY-coeff, Delta^2-scaled."""
        q = self.ctx._q4
        s = sk.s_mont
        fs = s.index_select(1, self._flip)
        t_r, t_i = self._mul_s_cols(tt.e1r_re, tt.e1r_im, fs)
        top = self._postmap(mm.add_mod(tt.e0_re, t_r, q),
                            mm.add_mod(tt.e0_im, t_i, q))
        u_r, u_i = self._mul_s_cols(tt.e2_re, tt.e2_im, fs)
        bot = self._postmap(mm.add_mod(tt.e1l_re, u_r, q),
                            mm.add_mod(tt.e1l_im, u_i, q))
        bot = self._mul_s_rows(*bot, s)
        return (_t(mm.add_mod(top[0], bot[0], q)),
                _t(mm.add_mod(top[1], bot[1], q)))

    def matmul(self, ctX: Tuple[Ciphertext, Ciphertext],
               ctY: Tuple[Ciphertext, Ciphertext]) -> MatmulTensor:
        """Homomorphic tensor for C = Y^H @ X (per lane)."""
        with span("gemm.tensor"):
            return self.tensor_fn(ctX[0], ctX[1], ctY[0], ctY[1])

    def decrypt_and_decode(self, tt: MatmulTensor, sk: SecretKey
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
        """[W, n, n] complex result pair; == Y^H @ X up to quantization and
        tensor noise."""
        with span("gemm.decrypt_decode"):
            with span("gemm.decrypt"):
                cr, ci = self.decrypt_fn(tt, sk)
            return self.ctx.batched_encoder.decode_from_wntt_eval(
                cr, ci, delta_override=float(self.params.delta) ** 2)
