"""Kernel K6: the trace GEMM, C = scale * A @ B^T complex mod q.

Counterpart of matrix_fhe_tpu/ops/pallas_cgemm.py (SlicedCGemm), the fused
batched complex modular GEMM under models/trace.trace_gemm.  Operands are
re/im int64 residues [L, W, n, n] (limb-major, any lane count W) and the
contraction runs over the last axis of both:

    re[l, w, r, c] = scale * sum_t (Ar Br - Ai Bi)[r, t; c, t] mod q_l
    im[l, w, r, c] = scale * sum_t (Ar Bi + Ai Br)[r, t; c, t] mod q_l

A CUDA tensor takes csrc/cgemm.cu; a CPU tensor takes the plain version,
the JAX XLA route's order of operations (four real modular GEMMs, mod-q
sub/add, times scale) on exact float64-digit matmuls (ops/modmatmul.py).
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch

from . import _backend as be
from .cuda_ntt import _bits
from .modmath import add_mod, kernel_consts, moduli_col, mul_mod, sub_mod
from .modmatmul import modmatmul

I64 = torch.int64


class CGemm:
    """K6 for one modulus chain and one scale, tables on `device`."""

    def __init__(self, moduli: Sequence[int], scale: int, device):
        self.moduli = tuple(int(q) for q in moduli)
        self.scale = int(scale)
        self.bits = _bits(self.moduli, 1)
        self.consts = kernel_consts(self.moduli, device, scale=self.scale)
        self.q = moduli_col(self.moduli, 3, device)
        self.scale_q = moduli_col([self.scale % q for q in self.moduli], 3,
                                  device)

    def __call__(self, a_re, a_im, b_re, b_im
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
        if be.on_device(a_re, a_im, b_re, b_im, self.q):
            return self.kernel(a_re, a_im, b_re, b_im)
        return self.plain(a_re, a_im, b_re, b_im)

    def plain(self, a_re, a_im, b_re, b_im) -> Tuple[torch.Tensor, torch.Tensor]:
        L, W, n, _ = a_re.shape
        q_lw = self.q.expand(L, W, 1, 1).reshape(L * W, 1, 1)

        def nt(a, b):       # (a @ b^T) mod q per (limb, lane)
            return modmatmul(b.reshape(L * W, n, n), a.reshape(L * W, n, n),
                             q_lw, self.bits, "right").reshape(L, W, n, n)

        re = sub_mod(nt(a_re, b_re), nt(a_im, b_im), self.q)
        im = add_mod(nt(a_re, b_im), nt(a_im, b_re), self.q)
        return mul_mod(re, self.scale_q, self.q), mul_mod(im, self.scale_q, self.q)

    def kernel(self, a_re, a_im, b_re, b_im) -> Tuple[torch.Tensor, torch.Tensor]:
        L = len(self.moduli)
        if a_re.dim() != 4 or a_re.shape[0] != L:
            raise ValueError(f"operands must be [L, W, n, n], got {tuple(a_re.shape)}")
        W, n = a_re.shape[1], a_re.shape[2]
        if n >= 1 << 15:
            raise ValueError(f"contraction of {n} terms: the 128-bit sums need n < 2^15")
        if L * W > 65535:
            raise ValueError(f"{L} limbs x {W} lanes exceed the kernel grid (65535)")
        for name, t in (("a_re", a_re), ("a_im", a_im), ("b_re", b_re),
                        ("b_im", b_im)):
            be.check(t, name, I64, (L, W, n, n))
        out = torch.empty((2, L, W, n, n), dtype=I64, device=a_re.device)
        be.launch("cgemm", "mf_cgemm", a_re.device, a_re, a_im, b_re, b_im,
                  self.consts, out[0], out[1], L, W, n)
        return out[0], out[1]
