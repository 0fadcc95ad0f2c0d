"""Exact modular arithmetic: host helpers and int64 tensor operations.

Residues are int64 tensors holding canonical values in [0, q) with every
modulus q < 2^56, so sums of two residues never overflow.  Products need
more than 64 bits; the plain tensor versions here build them from 4-bit
Horner steps, which keep every intermediate below 2^63 (q < 2^58) and use
only signed int64 operations that PyTorch defines on every device.

Host helpers (exact Python ints) mirror matrix_fhe_tpu/ops/modmath.py:
the Montgomery constants, the order-4n root search (ntt_core.cu:49-70) and
the order-p eta search (HE.cu:119-133).
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np
import torch

MASK64 = (1 << 64) - 1


def to_signed64(v: int) -> int:
    """A Python int taken mod 2^64, as the int64 with the same bits."""
    v &= MASK64
    return v - (1 << 64) if v >> 63 else v


# ---------------------------------------------------------------------------
# Host math (exact Python ints)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class MontConsts:
    """Montgomery constants for one modulus (R = 2^64)."""

    q: int
    qinv_neg: int  # -q^-1 mod 2^64
    r_mod: int     # 2^64 mod q
    r2: int        # (2^64)^2 mod q

    @classmethod
    def make(cls, q: int) -> "MontConsts":
        if q % 2 == 0 or q >= 1 << 63:
            raise ValueError("modulus must be odd and < 2^63")
        r = 1 << 64
        qinv = pow(q, -1, r)
        return cls(q=q, qinv_neg=(r - qinv) % r, r_mod=r % q,
                   r2=(r % q) ** 2 % q)


def find_psi_4n(q: int, n: int) -> int:
    """Smallest-root order-4n element with psi^(2n) == -1 (ntt_core.cu:49-70)."""
    order = 4 * n
    if (q - 1) % order != 0:
        raise ValueError(f"modulus {q} does not support NTT size {n}")
    root = 2
    while root <= 100000:
        g = pow(root, (q - 1) // order, q)
        if pow(g, 2 * n, q) == q - 1:
            return g
        root += 1
    raise ValueError(f"failed to find psi4n for mod {q}")


def find_eta(q: int, p: int, f1: int, f2: int) -> int:
    """Order-p root search, h_find_eta (HE.cu:119-133): smallest generator g
    from 2 upward with eta = g^((q-1)/p) of exact order p."""
    exp = (q - 1) // p
    for g in range(2, q):
        eta = pow(g, exp, q)
        if eta == 1:
            continue
        if pow(eta, p, q) != 1:
            continue
        if pow(eta, p // f1, q) == 1:
            continue
        if pow(eta, p // f2, q) == 1:
            continue
        return eta
    raise ValueError("failed to find eta for W-CRT")


def powers(root: int, count: int, q: int) -> np.ndarray:
    """root^e mod q for e in [0, count) as Python ints (object array),
    from two short Python loops and one outer product."""
    step = 1 << (count.bit_length() // 2)
    lo = [1]
    for _ in range(step - 1):
        lo.append(lo[-1] * root % q)
    big = pow(root, step, q)
    hi = [1]
    for _ in range(-(-count // step) - 1):
        hi.append(hi[-1] * big % q)
    out = (np.array(hi, dtype=object)[:, None]
           * np.array(lo, dtype=object)[None, :]) % q
    return out.reshape(-1)[:count]


def kernel_consts(moduli: Sequence[int], device) -> torch.Tensor:
    """[L, 3] int64 (bit patterns of uint64) per-limb constants
    (q, -q^-1 mod 2^64, 2^128 mod q), the layout the kernels read."""
    rows = []
    for q in moduli:
        c = MontConsts.make(int(q))
        rows.append([c.q, c.qinv_neg, c.r2])
    arr = np.array(rows, dtype=np.uint64).view(np.int64)
    return torch.from_numpy(arr.copy()).to(device)


def moduli_col(moduli: Sequence[int], extra_dims: int, device) -> torch.Tensor:
    """q as an int64 tensor [L, 1, ...] broadcasting over `extra_dims`."""
    q = torch.tensor([int(m) for m in moduli], dtype=torch.int64,
                     device=device)
    return q.reshape((len(moduli),) + (1,) * extra_dims)


# ---------------------------------------------------------------------------
# Element-wise mod-q ops on canonical int64 residues
# ---------------------------------------------------------------------------

def add_mod(a: torch.Tensor, b: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    s = a + b
    return torch.where(s >= q, s - q, s)


def sub_mod(a: torch.Tensor, b: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    d = a - b
    return torch.where(d < 0, d + q, d)


def neg_mod(a: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    return torch.where(a == 0, a, q - a)


def mul_mod(a: torch.Tensor, b: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """a * b mod q exactly, for a, b in [0, q) and q < 2^58: Horner over the
    fifteen 4-bit digits of b, every intermediate < 2^63."""
    acc = torch.zeros(torch.broadcast_shapes(a.shape, b.shape, q.shape),
                      dtype=torch.int64, device=a.device)
    for shift in range(56, -4, -4):
        acc = (acc * 16) % q
        acc = (acc + a * ((b >> shift) & 15)) % q
    return acc


def shl_mod(a: torch.Tensor, bits: int, q: torch.Tensor) -> torch.Tensor:
    """a * 2^bits mod q for a in [0, q), q < 2^59."""
    for _ in range(bits // 4):
        a = (a * 16) % q
    for _ in range(bits % 4):
        a = (a * 2) % q
    return a


def umod64(x: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """x read as an unsigned 64-bit integer (int64 bit pattern), mod q,
    for q < 2^59."""
    hi = (x >> 32) & 0xFFFFFFFF
    lo = x & 0xFFFFFFFF
    return (shl_mod(hi % q, 32, q) + lo) % q


def shr_logical(x: torch.Tensor, bits: int) -> torch.Tensor:
    """Logical right shift of the int64 bit pattern (0 < bits < 64)."""
    return (x >> bits) & ((1 << (64 - bits)) - 1)


def to_mont(a: torch.Tensor, moduli: Sequence[int]) -> torch.Tensor:
    """a -> a * 2^64 mod q per limb (the SecretKey storage form); a is
    [L, ...] canonical."""
    q = moduli_col(moduli, a.dim() - 1, a.device)
    r = moduli_col([MontConsts.make(int(m)).r_mod for m in moduli],
                   a.dim() - 1, a.device)
    return mul_mod(a, r, q)
