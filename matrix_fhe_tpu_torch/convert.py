"""JAX package state -> port state.

Turns the uint64 arrays of matrix_fhe_tpu objects (secret keys,
ciphertexts, homomorphic-GEMM tensors, relinearization and Galois keys,
the switch keys of both rings and of gl2 conjugation, a leveled chain's
keys, tables) into the port's int64 tensors on a given device, so that
both packages can compute on the same keys and ciphertexts.  Objects are
read through their attributes and np.asarray, so this module does not
import jax.  Residues are canonical (< 2^56), so the uint64 -> int64
reinterpretation keeps every value.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .models.he import Ciphertext, SecretKey
from .models.he2 import Ciphertext2, SecretKey2
from .models.he_matmul import MatmulTensor
from .models.he_matmul2 import GemmRelinKey, GemmTensor2, Gl2Conj, HEMatmul2
from .models.keyswitch import (FullGaloisKeys, GaloisKeys, RelinContext,
                               RelinKey, XGaloisKeys)


def residues(x, device="cpu") -> torch.Tensor:
    """uint64 residues (numpy or jax array) -> int64 tensor on `device`."""
    arr = np.ascontiguousarray(np.asarray(x))
    if arr.dtype == np.uint64:
        if arr.size and int(arr.max()) >= 1 << 63:
            raise ValueError("value >= 2^63 is not a canonical residue")
        arr = arr.view(np.int64)
    return torch.from_numpy(arr.copy()).to(device)


def secret_key(sk, device="cpu") -> SecretKey:
    """matrix_fhe_tpu SecretKey -> port SecretKey (s_mont [L, W, n])."""
    return SecretKey(residues(sk.s_mont, device))


def ciphertext(ct, device="cpu") -> Ciphertext:
    """matrix_fhe_tpu Ciphertext -> port Ciphertext (b, a) [L, W, n, n]."""
    return Ciphertext(b=residues(ct.b, device), a=residues(ct.a, device))


def matmul_tensor(tt, device="cpu") -> MatmulTensor:
    """matrix_fhe_tpu MatmulTensor -> port MatmulTensor (eight [L, W, n, n])."""
    return MatmulTensor(*(residues(x, device) for x in tt))


def secret_key2(sk, device="cpu") -> SecretKey2:
    """matrix_fhe_tpu SecretKey2 -> port SecretKey2 (s_mont [L, W, 2n],
    s_sign [W, 2n] int8)."""
    sign = np.asarray(sk.s_sign).astype(np.int8)
    return SecretKey2(residues(sk.s_mont, device),
                      torch.from_numpy(sign.copy()).to(device))


def ciphertext2(ct, device="cpu") -> Ciphertext2:
    """matrix_fhe_tpu Ciphertext2 -> port Ciphertext2 (b, a) [L, W, y, 2n]."""
    return Ciphertext2(b=residues(ct.b, device), a=residues(ct.a, device))


def gemm_tensor2(tt, device="cpu") -> GemmTensor2:
    """matrix_fhe_tpu GemmTensor2 -> port GemmTensor2 (four [L, W, 2n, 2n])."""
    return GemmTensor2(*(residues(x, device) for x in tt))


def gemm_relin_key(ks, device="cpu") -> GemmRelinKey:
    """matrix_fhe_tpu GemmRelinKey -> port GemmRelinKey (per-digit
    [Lqp, W, 2n, 2n] in the same storage form)."""
    return GemmRelinKey(*(tuple(residues(x, device) for x in part)
                          for part in ks))


def relin_key(rlk, device="cpu") -> RelinKey:
    """matrix_fhe_tpu RelinKey (or any switch key) -> port RelinKey, per
    digit [Lqp, W, y, x] in the same storage form x * 2^64 mod q."""
    return RelinKey(b=tuple(residues(x, device) for x in rlk.b),
                    a=tuple(residues(x, device) for x in rlk.a))


def gl2_conj(cj, hm: HEMatmul2, rc: RelinContext) -> Gl2Conj:
    """matrix_fhe_tpu Gl2Conj -> port Gl2Conj over `hm` and `rc`, with the
    JAX switch key (per digit [Lqp, W, n, 2n])."""
    return Gl2Conj.from_key(hm, rc, relin_key(cj._ksk, rc.ctx.device))


def galois_keys(gk, rc: RelinContext) -> GaloisKeys:
    """matrix_fhe_tpu GaloisKeys -> port GaloisKeys bound to `rc`."""
    dev = rc.ctx.device
    return GaloisKeys.from_keys(
        rc, {int(j): np.asarray(p) for j, p in gk._perms.items()},
        {int(j): relin_key(k, dev) for j, k in gk._keys.items()})


def full_galois_keys(fk, rc: RelinContext) -> FullGaloisKeys:
    """matrix_fhe_tpu FullGaloisKeys -> port FullGaloisKeys bound to `rc`."""
    dev = rc.ctx.device
    return FullGaloisKeys.from_keys(
        rc, {int(j): relin_key(k, dev) for j, k in fk._gk._keys.items()})


def x_galois_keys(xg, rc: RelinContext) -> XGaloisKeys:
    """matrix_fhe_tpu XGaloisKeys -> port XGaloisKeys bound to `rc`."""
    dev = rc.ctx.device
    return XGaloisKeys.from_keys(
        rc, int(xg.x_dim),
        {int(k): relin_key(key, dev) for k, key in xg._keys.items()})


def leveled_keys(jax_chain, chain) -> None:
    """Install a matrix_fhe_tpu LeveledChain's relinearization and Galois
    keys (those it has made so far) into the port's LeveledChain `chain`
    over the same parameters, level by level."""
    for level, rlk in jax_chain._rlk.items():
        chain._rlk[level] = relin_key(rlk, chain.device)
    for k, gk in jax_chain._gk.items():
        if k[0] == "full":
            chain._gk[k] = full_galois_keys(gk, chain.rc(k[1]))
        else:
            chain._gk[k] = galois_keys(gk, chain.rc(k[0]))


def tables(t, device="cpu") -> dict:
    """Every field of a GLTables (either package's) as a tensor on
    `device`: uint64 tables -> int64, other arrays keep their dtype,
    tuples of ints -> int64 tensors; `params` is passed through."""
    out = {}
    for f in dataclasses.fields(t):
        v = getattr(t, f.name)
        if f.name == "params":
            out[f.name] = v
        elif isinstance(v, np.ndarray) and v.dtype == np.uint64:
            out[f.name] = torch.from_numpy(
                np.ascontiguousarray(v).view(np.int64).copy()).to(device)
        elif isinstance(v, np.ndarray):
            out[f.name] = torch.from_numpy(v.copy()).to(device)
        elif isinstance(v, tuple):
            out[f.name] = torch.tensor([int(x) for x in v], dtype=torch.int64,
                                       device=device)
        else:
            out[f.name] = int(v)
    return out
