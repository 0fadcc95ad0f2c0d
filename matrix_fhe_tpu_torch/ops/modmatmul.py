"""Exact modular matrix multiplication in plain PyTorch.

This is the plain version under kernels K1, K2 and K3.  PyTorch has no
int64 matmul on CUDA and no 128-bit integers, so the product is built from
float64 matmuls over 16-bit digits: with both operands split into 16-bit
digits, each digit product is < 2^32 and a contraction of K <= 2^19 terms
(four digit pairs per diagonal) stays below 2^53, where float64 sums of
integers are exact in any order.  The diagonal sums are then folded back
mod q with exact int64 Horner steps.

    table: [L, W, K], data [L, K, M] (side "left")  -> [L, W, M]
    table: [L, W, K], data [L, R, K] (side "right") -> [L, R, W]
"""

from __future__ import annotations

from typing import List

import torch

from .modmath import shl_mod

DIGIT_BITS = 16
_DIGIT_MASK = (1 << DIGIT_BITS) - 1


def _digits(x: torch.Tensor, count: int) -> List[torch.Tensor]:
    return [((x >> (DIGIT_BITS * i)) & _DIGIT_MASK).to(torch.float64)
            for i in range(count)]


def fold_diagonals(diags: List[torch.Tensor], q: torch.Tensor) -> torch.Tensor:
    """sum_s diags[s] * 2^(16 s) mod q, for nonnegative int64 diagonal sums
    below 2^53 and q < 2^59."""
    acc = None
    for d in reversed(diags):
        acc = d % q if acc is None else (shl_mod(acc, DIGIT_BITS, q) + d) % q
    return acc


def modmatmul(table: torch.Tensor, data: torch.Tensor, q: torch.Tensor,
              bits: int, side: str = "left") -> torch.Tensor:
    """Exact (table @ data) mod q per limb (side "left") or
    (data @ table^T) mod q (side "right"); canonical int64 inputs < 2^bits,
    q [L, 1, 1]."""
    if side not in ("left", "right"):
        raise ValueError(f"side must be 'left' or 'right', not {side!r}")
    if table.shape[-1] >= 1 << 19:
        raise ValueError("contraction too long for exact float64 digit sums")
    nd = -(-bits // DIGIT_BITS)
    td = _digits(table, nd)
    dd = _digits(data, nd)
    diags: List[torch.Tensor] = [None] * (2 * nd - 1)
    for i in range(nd):
        t = td[i] if side == "left" else td[i].transpose(1, 2)
        for j in range(nd):
            p = t @ dd[j] if side == "left" else dd[j] @ t
            diags[i + j] = p if diags[i + j] is None else diags[i + j] + p
    return fold_diagonals([d.to(torch.int64) for d in diags], q)
