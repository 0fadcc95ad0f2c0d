"""Exact integer helpers of the decode and encode chains.

Counterpart of the parts of matrix_fhe_tpu/ops/ddfloat.py that the HE
roundtrip runs: the dynamic shift-round of fixed-point words, the tail of
the fused CRT compose, and llround in f64.  Words are int64 tensors holding
u32 values (the JAX planes' values), so every shift below stays inside 64
bits.
"""

from __future__ import annotations

import torch

from .modmath import to_signed64

M32 = 0xFFFFFFFF


def pow2(e: torch.Tensor) -> torch.Tensor:
    """2.0 ** e as float64, built from its bits (exact on every device);
    e is an integer tensor in the normal range [-1022, 1023]."""
    return ((e.to(torch.int64) + 1023) << 52).view(torch.float64)


def llround_f64(x: torch.Tensor) -> torch.Tensor:
    """llround (round half away from zero), kept in f64 (exact for
    |x| < 2^52)."""
    return torch.sign(x) * torch.floor(torch.abs(x) + 0.5)


def words_shr_round(m0, m1, m2, sh):
    """round-half-up((m0 + m1 2^32 + m2 2^64) >> sh) as u32-valued (lo, hi).

    sh: int64 scalar tensor; the JAX function's u32 arithmetic is kept,
    including the wrap of sh - 1 at sh = 0 (ddfloat.py:223-250)."""
    sh = sh & M32
    k = sh // 32
    b = sh - k * 32

    def funnel(a, nxt):
        return ((a >> b) | (((nxt << (31 - b)) & 0x7FFFFFFF) << 1)) & M32

    zero = torch.zeros_like(m2)
    lo = torch.where(k == 0, funnel(m0, m1),
                     torch.where(k == 1, funnel(m1, m2), m2 >> b))
    hi = torch.where(k == 0, funnel(m1, m2),
                     torch.where(k == 1, m2 >> b, zero))
    sb = (sh - 1) & M32
    j = sb // 32
    c = sb - j * 32
    rb = torch.where(j == 0, m0 >> c,
                     torch.where(j == 1, m1 >> c, m2 >> c)) & 1
    lo2 = (lo + rb) & M32
    hi = (hi + (lo2 < lo).to(torch.int64)) & M32
    return lo2, hi


def compose_tail_from_partials(acc: torch.Tensor, k: torch.Tensor,
                               big_q: int, delta: float) -> torch.Tensor:
    """Finish the fused compose: x = (acc - k * Q) mod 2^64 read as a signed
    int64 (|x| < 2^63), divided by delta (f64)."""
    y = acc - k * to_signed64(big_q)                 # wraps mod 2^64
    return y.to(torch.float64) / float(delta)
