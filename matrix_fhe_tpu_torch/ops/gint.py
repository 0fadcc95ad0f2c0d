"""Gaussian-integer RNS element operations.

Counterpart of matrix_fhe_tpu/ops/gint.py (the reference's GaussianIntRNS,
gpu_math.cuh:11-91): x + iy held as per-limb residue pairs, limb-major
[L, ...] int64 with any trailing shape, with add / sub / mul / conj /
mul_by_neg_i.
"""

from __future__ import annotations

from typing import NamedTuple, Sequence

import torch

from . import modmath as mm


class GaussianIntRNS(NamedTuple):
    """x + iy over the RNS basis; components limb-major [L, ...] int64."""
    x: torch.Tensor
    y: torch.Tensor


def _q(moduli: Sequence[int], like: torch.Tensor) -> torch.Tensor:
    return mm.moduli_col(moduli, like.dim() - 1, like.device)


def add(a: GaussianIntRNS, b: GaussianIntRNS, moduli) -> GaussianIntRNS:
    q = _q(moduli, a.x)
    return GaussianIntRNS(mm.add_mod(a.x, b.x, q), mm.add_mod(a.y, b.y, q))


def sub(a: GaussianIntRNS, b: GaussianIntRNS, moduli) -> GaussianIntRNS:
    q = _q(moduli, a.x)
    return GaussianIntRNS(mm.sub_mod(a.x, b.x, q), mm.sub_mod(a.y, b.y, q))


def mul(a: GaussianIntRNS, b: GaussianIntRNS, moduli) -> GaussianIntRNS:
    """(a.x + i a.y)(b.x + i b.y), four modular products per limb
    (gpu_math.cuh:52-76)."""
    q = _q(moduli, a.x)
    xx = mm.mul_mod(a.x, b.x, q)
    yy = mm.mul_mod(a.y, b.y, q)
    xy = mm.mul_mod(a.x, b.y, q)
    yx = mm.mul_mod(a.y, b.x, q)
    return GaussianIntRNS(mm.sub_mod(xx, yy, q), mm.add_mod(xy, yx, q))


def conj(a: GaussianIntRNS, moduli) -> GaussianIntRNS:
    """x - iy (gpu_math.cuh:78-82)."""
    return GaussianIntRNS(a.x, mm.neg_mod(a.y, _q(moduli, a.x)))


def mul_by_neg_i(a: GaussianIntRNS, moduli) -> GaussianIntRNS:
    """-i (x + iy) = y - ix (gpu_math.cuh:84-90), the B'-map twist scalar."""
    return GaussianIntRNS(a.y, mm.neg_mod(a.x, _q(moduli, a.x)))
