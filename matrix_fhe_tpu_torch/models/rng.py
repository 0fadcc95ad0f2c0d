"""Deterministic randomness bit-compatible with the reference, plus a fresh
path on torch.Generator.

Counterpart of matrix_fhe_tpu/models/rng.py.  The parity streams are pure
functions of position (HE.cu:564-627, 690-713), written here on int64
tensors whose bit patterns are the reference's uint64 values: additions
and multiplications wrap mod 2^64, right shifts are made logical, and
remainders go through modmath.umod64.

  * uniform `a`: LCG of (123456789 + flat index) over the reference's
    [W][L][y][x] layout, mod q;
  * ternary secret: a hash of (w, x) mapped to {0, 1, q-1};
  * Gaussian noise (sigma): splitmix64 -> Box-Muller -> llround, the same
    integer in every limb.  The f64 log/cos/sqrt may differ from XLA's by
    an ulp, which moves the rounded integer only at a half-integer.
"""

from __future__ import annotations

import torch

from ..config import GLParams
from ..ops.modmath import moduli_col, shr_logical, to_signed64, umod64

I64 = torch.int64


def _iota(size: int, axis: int, ndim: int, device) -> torch.Tensor:
    shape = [1] * ndim
    shape[axis] = size
    return torch.arange(size, dtype=I64, device=device).reshape(shape)


def _residues(noise: torch.Tensor, params: GLParams) -> torch.Tensor:
    """Small signed integers [...] -> canonical residues [L, ...]."""
    q = moduli_col(params.moduli, noise.dim(), noise.device)
    return torch.where(noise >= 0, noise, q + noise).expand(
        (params.num_limbs,) + tuple(noise.shape)).contiguous()


def uniform_a(params: GLParams, device) -> torch.Tensor:
    """Reference-exact uniform polynomial in W-coeff domain, [L, W, n, n]
    (uniform_random_kernel, HE.cu:564-578)."""
    L, W, n = params.num_limbs, params.phi, params.n
    l = _iota(L, 0, 4, device)
    w = _iota(W, 1, 4, device)
    y = _iota(n, 2, 4, device)
    x = _iota(n, 3, 4, device)
    idx = (w * L + l) * (n * n) + y * n + x
    seed = (123456789 + idx) * to_signed64(6364136223846793005) \
        + to_signed64(1442695040888963407)
    return umod64(seed, moduli_col(params.moduli, 3, device))


def ternary_secret(params: GLParams, device) -> torch.Tensor:
    """Reference-exact ternary secret in W-coeff domain, [L, W, n]
    (ternary_secret_kernel, HE.cu:690-713): 0 -> 0, 1 -> 1, 2 -> q-1."""
    W, n = params.phi, params.n
    w = _iota(W, 0, 2, device)
    x = _iota(n, 1, 2, device)
    t = w * 1315423911 + x * 2654435761
    r = umod64(t * to_signed64(11400714819323198485),
               torch.tensor(3, dtype=I64, device=device))
    return _residues(torch.where(r == 2, -1, r), params)


def splitmix64(x: torch.Tensor) -> torch.Tensor:
    x = x + to_signed64(0x9E3779B97F4A7C15)
    x = (x ^ shr_logical(x, 30)) * to_signed64(0xBF58476D1CE4E5B9)
    x = (x ^ shr_logical(x, 27)) * to_signed64(0x94D049BB133111EB)
    return x ^ shr_logical(x, 31)


def llround(z: torch.Tensor) -> torch.Tensor:
    """C llround (round half away from zero) -> int64."""
    return torch.where(z >= 0, torch.floor(z + 0.5),
                       torch.ceil(z - 0.5)).to(I64)


def gaussian_noise(params: GLParams, device) -> torch.Tensor:
    """Discrete Gaussian (sigma, Box-Muller, llround) in W-coeff domain,
    [L, W, n, n] (gaussian_noise_kernel, HE.cu:581-627)."""
    W, n = params.phi, params.n
    coeff_id = (_iota(W, 0, 3, device) * (n * n) + _iota(n, 1, 3, device) * n
                + _iota(n, 2, 3, device))
    r1 = splitmix64(to_signed64(0xD6E8FEB86659FD93) ^ coeff_id)
    r2 = splitmix64(r1)
    inv53 = 1.0 / 9007199254740992.0  # 2^-53
    u1 = (shr_logical(r1, 11).to(torch.float64) + 1.0) * inv53
    u2 = (shr_logical(r2, 11).to(torch.float64) + 1.0) * inv53
    mag = params.sigma * torch.sqrt(-2.0 * torch.log(u1))
    z = mag * torch.cos(6.283185307179586 * u2)
    return _residues(llround(z), params)


# ---------------------------------------------------------------------------
# Fresh randomness for real key material (torch.Generator)
# ---------------------------------------------------------------------------

def fresh_uniform_a(gen: torch.Generator, params: GLParams,
                    device, shape=None) -> torch.Tensor:
    """Uniform residues [L, *shape] (default shape (W, n, n)), drawn on the
    generator's device limb by limb in limb order.  Rectangular frames,
    such as the gl2 ring's [W, n, 2n] and its 2D tensor's [W, 2n, 2n],
    pass `shape` (matrix_fhe_tpu/models/rng.py:203-211)."""
    shape = (params.phi, params.n, params.n) if shape is None else tuple(shape)
    return torch.stack([
        torch.randint(0, int(q), shape, generator=gen, dtype=I64,
                      device=gen.device)
        for q in params.moduli]).to(device)


def fresh_ternary_secret(gen: torch.Generator, params: GLParams,
                         device) -> torch.Tensor:
    r = torch.randint(0, 3, (params.phi, params.n), generator=gen,
                      dtype=I64, device=gen.device).to(device)
    return _residues(torch.where(r == 2, -1, r), params)


def fresh_gaussian_noise(gen: torch.Generator, params: GLParams,
                         device, shape=None) -> torch.Tensor:
    """Rounded Gaussian (sigma) [L, *shape] (default shape (W, n, n)), the
    same integer in every limb (matrix_fhe_tpu/models/rng.py:223-233)."""
    shape = (params.phi, params.n, params.n) if shape is None else tuple(shape)
    z = torch.randn(shape, generator=gen, dtype=torch.float64,
                    device=gen.device) * params.sigma
    return _residues(llround(z).to(device), params)
