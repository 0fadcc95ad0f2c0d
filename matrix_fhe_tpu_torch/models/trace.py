"""Homomorphic matrix-multiplication primitive via the algebraic field trace.

Counterpart of matrix_fhe_tpu/models/trace.py (src/core/trace.cu and
batched_trace.cu there): C = A * (B')^T over Gaussian-integer RNS, where
B' = conj(B(X^-1, Y)) under the X^n = i twist.

  * map_b_to_bprime: row permutation j -> (-j mod n), conjugation, and the
    -i scalar on off-diagonal rows (map_Bprime_Xinv_twist_kernel,
    trace.cu:30-73);
  * trace_gemm: n * A @ (B')^T, complex modular, kernel K6 (ops/cgemm.py);
  * rescale_by_delta: per-limb multiply by Delta^-1 (trace.cu:132-161).

Inputs are limb-major [L, ..., n, n] int64 residues (any batch axes between
the limb axis and the matrix axes, e.g. [L, W, n, n]).
"""

from __future__ import annotations

import functools
from typing import Sequence, Tuple

import numpy as np
import torch

from ..config import GLParams
from ..ops import modmath as mm
from ..ops.cgemm import CGemm


def map_b_to_bprime(b_re: torch.Tensor, b_im: torch.Tensor, params: GLParams
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """B -> B' (conj + X^-1 twist).  [L, ..., n(row j), n(col k)]."""
    n = params.n
    q = mm.moduli_col(params.moduli, b_re.dim() - 1, b_re.device)
    # dst row j receives src row (n - j) mod n
    src = torch.from_numpy((-np.arange(n)) % n).to(b_re.device)
    a = b_re.index_select(-2, src)
    b = b_im.index_select(-2, src)
    is_row0 = (torch.arange(n, device=b_re.device) == 0).reshape(n, 1)
    return (torch.where(is_row0, a, mm.neg_mod(b, q)),
            torch.where(is_row0, mm.neg_mod(b, q), mm.neg_mod(a, q)))


@functools.lru_cache(maxsize=None)
def _cgemm(moduli: Tuple[int, ...], scale: int, device: torch.device) -> CGemm:
    return CGemm(moduli, scale, device)


def trace_gemm(a_re, a_im, bp_re, bp_im, params: GLParams
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """C = n * A @ (B')^T, complex modular (kernel K6):
    out[.., row, col] = n * sum_t A[.., row, t] * B'[.., col, t] mod q."""
    n, L, shape = params.n, a_re.shape[0], a_re.shape
    gemm = _cgemm(tuple(int(q) for q in params.moduli), n, a_re.device)

    def flat(t):        # the kernel takes contiguous [L, W, n, n]
        return t.reshape(L, -1, n, n).contiguous()

    c_re, c_im = gemm(flat(a_re), flat(a_im), flat(bp_re), flat(bp_im))
    return c_re.reshape(shape), c_im.reshape(shape)


def rescale_by_delta(c_re, c_im, params: GLParams,
                     inv: Sequence[int] | None = None):
    """Multiply by Delta^-1 mod q per limb (rescale_by_delta_rns).  By default
    the exact per-limb inverse of Delta is used for every limb."""
    moduli = params.moduli
    if inv is None:
        d = int(params.delta)
        inv = [pow(d % q, -1, q) for q in moduli]
    q = mm.moduli_col(moduli, c_re.dim() - 1, c_re.device)
    iv = mm.moduli_col([int(v) for v in inv], c_re.dim() - 1, c_re.device)
    return mm.mul_mod(c_re, iv, q), mm.mul_mod(c_im, iv, q)


def trace_matmul(a_re, a_im, b_re, b_im, params: GLParams, rescale=True):
    """Full homomorphic-GEMM plaintext primitive: map, GEMM, rescale."""
    bp_re, bp_im = map_b_to_bprime(b_re, b_im, params)
    c_re, c_im = trace_gemm(a_re, a_im, bp_re, bp_im, params)
    if rescale:
        c_re, c_im = rescale_by_delta(c_re, c_im, params)
    return c_re, c_im
