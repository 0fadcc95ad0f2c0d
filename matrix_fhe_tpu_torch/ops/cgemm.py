"""Kernels K6 and K7: the modular GEMMs of the two homomorphic products.

K6 is the trace GEMM, C = scale * A @ B^T complex mod q.

Counterpart of matrix_fhe_tpu/ops/pallas_cgemm.py (SlicedCGemm), the fused
batched complex modular GEMM under models/trace.trace_gemm.  Operands are
re/im int64 residues [L, W, n, n] (limb-major, any lane count W) and the
contraction runs over the last axis of both:

    re[l, w, r, c] = scale * sum_t (Ar Br - Ai Bi)[r, t; c, t] mod q_l
    im[l, w, r, c] = scale * sum_t (Ar Bi + Ai Br)[r, t; c, t] mod q_l

A CUDA tensor takes csrc/cgemm.cu (u8 digit-plane GEMMs on the int8 tensor
cores, B pre-reduced per digit of A inside the kernel with scale folded in,
re and im on the two warpgroups of a block); a CPU tensor takes the plain
version, the JAX XLA route's order of operations (four real modular GEMMs,
mod-q sub/add, times scale) on exact float64-digit matmuls
(ops/modmatmul.py).

K7 is the gl2 ciphertext GEMM's tensor step (Gemm2x2, counterpart of
matrix_fhe_tpu/ops/pallas_cgemm.py SlicedGemm2x2): four real modular GEMMs
contracting the second-to-last axis of [L, W, y, m] operands,

    E_ij[l, w, a, b] = scale * sum_y U_i[l, w, y, a] V_j[l, w, y, b] mod q_l,

csrc/gemm2x2.cu on CUDA tensors (u8 digit-plane GEMMs on the int8 tensor
cores, V pre-reduced per data digit inside the kernel with scale folded
in), and on CPU tensors the plain version: four exact float64-digit modular
matmuls times scale, the function of JAX's XLA oracle HEMatmul2._mod_gemm.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch

from . import _backend as be
from .cuda_ntt import _bits, digit_count
from .modmath import (add_mod, kernel_consts, moduli_col, mul_mod, sub_mod,
                      to_signed64)
from .modmatmul import modmatmul

I64 = torch.int64


def shoup_digit_consts(moduli: Sequence[int], scale: int, device
                       ) -> torch.Tensor:
    """[L, 8, 2] int64: per limb and digit c, the Shoup pair of K6's and
    K7's pre-reduction of their B / V operand, w_c = scale 2^(8 c) 2^64 mod q
    and floor(w_c 2^64 / q)."""
    w = [[scale * pow(2, 8 * c + 64, q) % q for c in range(8)]
         for q in moduli]
    return torch.tensor([[[wc, to_signed64((wc << 64) // q)] for wc in row]
                         for row, q in zip(w, moduli)], dtype=I64,
                        device=device)


class CGemm:
    """K6 for one modulus chain and one scale, constants on `device`.

    The kernel pre-reduces B per digit c of A, B w_c mod q with
    w_c = scale 2^(8 c) 2^64 mod q by Shoup's method (`vconsts`, as K7's),
    and -Bi w_c mod q as q - (Bi w_c mod q), so one Montgomery REDC of each
    output's folded digit-plane sums gives re and im with scale in."""

    def __init__(self, moduli: Sequence[int], scale: int, device):
        self.moduli = tuple(int(q) for q in moduli)
        self.scale = int(scale)
        self.bits = _bits(self.moduli, 1)
        self.consts = kernel_consts(self.moduli, device)
        self.vconsts = shoup_digit_consts(self.moduli, self.scale, device)
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
            raise ValueError(f"contraction of {n} terms: the kernel takes n < 2^15")
        for name, t in (("a_re", a_re), ("a_im", a_im), ("b_re", b_re),
                        ("b_im", b_im)):
            be.check(t, name, I64, (L, W, n, n))
        out = torch.empty((2, L, W, n, n), dtype=I64, device=a_re.device)
        be.launch("cgemm", "mf_cgemm", a_re.device, a_re, a_im, b_re, b_im,
                  self.consts, self.vconsts, out[0], out[1], L, W, n)
        return out[0], out[1]


class Gemm2x2:
    """K7 for one modulus chain and one scale, constants on `device`.

    The kernel pre-reduces V per data digit c, V w_c mod q with
    w_c = scale 2^(8 c) 2^64 mod q by Shoup's method (`vconsts`, [L, 8, 2]:
    w_c and floor(w_c 2^64 / q)), so one Montgomery REDC of each output's
    folded digit-plane sums gives scale U_i^T V_j mod q."""

    def __init__(self, moduli: Sequence[int], scale: int, device):
        self.moduli = tuple(int(q) for q in moduli)
        self.scale = int(scale)
        self.bits = _bits(self.moduli, 1)
        self.consts = kernel_consts(self.moduli, device)
        self.vconsts = shoup_digit_consts(self.moduli, self.scale, device)
        self.dmax = max(map(digit_count, self.moduli))
        self.q = moduli_col(self.moduli, 3, device)
        self.scale_q = moduli_col([self.scale % q for q in self.moduli], 3,
                                  device)

    def __call__(self, u1, u2, v1, v2) -> Tuple[torch.Tensor, ...]:
        if be.on_device(u1, u2, v1, v2, self.q):
            return self.kernel(u1, u2, v1, v2)
        return self.plain(u1, u2, v1, v2)

    def plain(self, u1, u2, v1, v2) -> Tuple[torch.Tensor, ...]:
        L, W, y, m = u1.shape
        q_lw = self.q.expand(L, W, 1, 1).reshape(L * W, 1, 1)

        def tn(u, v):       # (u^T @ v) mod q per (limb, lane), times scale
            e = modmatmul(u.reshape(L * W, y, m).transpose(1, 2),
                          v.reshape(L * W, y, m), q_lw, self.bits, "left")
            return mul_mod(e.reshape(L, W, m, m), self.scale_q, self.q)

        return tn(u1, v1), tn(u1, v2), tn(u2, v1), tn(u2, v2)

    def kernel(self, u1, u2, v1, v2) -> Tuple[torch.Tensor, ...]:
        L = len(self.moduli)
        if u1.dim() != 4 or u1.shape[0] != L:
            raise ValueError(f"operands must be [L, W, y, m], got {tuple(u1.shape)}")
        W, y, m = u1.shape[1:]
        if y > 1 << 16:
            raise ValueError(f"contraction of {y} terms: the kernel takes "
                             "y <= 2^16")
        for name, t in (("u1", u1), ("u2", u2), ("v1", v1), ("v2", v2)):
            be.check(t, name, I64, (L, W, y, m))
        out = torch.empty((4, L, W, m, m), dtype=I64, device=u1.device)
        be.launch("gemm2x2", "mf_gemm2x2", u1.device, u1, u2, v1, v2,
                  self.consts, self.vconsts, out, L, W, y, m, self.dmax)
        return tuple(out.unbind(0))
