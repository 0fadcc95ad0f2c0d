"""ctypes binding for the native golden-model oracle.

Compiles the port's own copy of the oracle, native/golden.cpp beside this
file, with g++ into matrix_fhe_tpu_torch/_build/libgolden.so on first use
(rebuilt when the source is newer), as native/tablegen.py does.  The oracle
is independent of the port: plain C++ on numpy uint64 arrays, written from
the math.  `available()` gates use, so callers skip where no C++
toolchain exists.
"""

from __future__ import annotations

import ctypes
import functools
import os
import subprocess

import numpy as np

from .tablegen import build_library

_PORT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE = os.path.join(_PORT, "native", "golden.cpp")
LIBRARY = os.path.join(_PORT, "_build", "libgolden.so")

_U64P = ctypes.POINTER(ctypes.c_uint64)
_LL = ctypes.c_longlong


@functools.cache
def _lib():
    """The loaded library, or None when it cannot be built or loaded."""
    try:
        lib = ctypes.CDLL(build_library(SOURCE, LIBRARY))
    except (OSError, subprocess.SubprocessError):
        return None
    lib.mf_polymul_wrap.argtypes = [ctypes.c_uint64, ctypes.c_uint64, _LL,
                                    _U64P, _U64P, _U64P]
    lib.mf_mod_matvec.argtypes = [ctypes.c_uint64, _LL, _LL,
                                  _U64P, _U64P, _U64P]
    lib.mf_uniform_a.argtypes = [_LL, _LL, _LL, _U64P, _U64P]
    lib.mf_ternary_secret.argtypes = [_LL, _LL, _LL, _U64P, _U64P]
    lib.mf_gaussian_noise.argtypes = [_LL, _LL, _LL, ctypes.c_double,
                                      _U64P, _U64P]
    lib.mf_crt_compose_centered.argtypes = [
        _LL, _U64P, _U64P, _U64P, _U64P, _U64P, _U64P, _LL, _U64P,
        ctypes.POINTER(_LL)]
    lib.mf_ntt_polymul.argtypes = [ctypes.c_uint64, _LL,
                                   _U64P, _U64P, _U64P, _U64P, _U64P]
    for f in (lib.mf_polymul_wrap, lib.mf_mod_matvec, lib.mf_uniform_a,
              lib.mf_ternary_secret, lib.mf_gaussian_noise,
              lib.mf_crt_compose_centered, lib.mf_ntt_polymul):
        f.restype = None
    return lib


def available() -> bool:
    return _lib() is not None


def _u64(a) -> np.ndarray:
    return np.ascontiguousarray(a, dtype=np.uint64)


def _p(a: np.ndarray):
    return a.ctypes.data_as(_U64P)


def _same_size(*arrays) -> None:
    if len({x.size for x in arrays}) != 1:
        raise ValueError(f"sizes differ: {[x.size for x in arrays]}")


def _moduli(moduli, L: int) -> np.ndarray:
    q = _u64(moduli)
    if q.size != L:
        raise ValueError(f"{q.size} moduli for {L} limbs")
    return q


def polymul_wrap(q: int, wrap: int, a, b) -> np.ndarray:
    """Schoolbook a * b mod (X^n - wrap) mod q of two length-n vectors."""
    a, b = _u64(a), _u64(b)
    _same_size(a, b)
    out = np.zeros(a.size, dtype=np.uint64)
    _lib().mf_polymul_wrap(q, wrap, a.size, _p(a), _p(b), _p(out))
    return out


def mod_matvec(q: int, table, x) -> np.ndarray:
    """out[w] = sum_r table[w, r] x[r] mod q (one W-CRT / X-NTT matvec)."""
    table, x = _u64(table), _u64(x)
    rows, cols = table.shape
    if x.size != cols:
        raise ValueError(f"table [{rows}, {cols}] against x of {x.size}")
    out = np.zeros(rows, dtype=np.uint64)
    _lib().mf_mod_matvec(q, rows, cols, _p(table), _p(x), _p(out))
    return out


def uniform_a(L: int, W: int, n: int, moduli) -> np.ndarray:
    """The reference's uniform stream (HE.cu:564-578), [L, W, n, n]."""
    out = np.zeros((L, W, n, n), dtype=np.uint64)
    _lib().mf_uniform_a(L, W, n, _p(_moduli(moduli, L)), _p(out))
    return out


def ternary_secret(L: int, W: int, n: int, moduli) -> np.ndarray:
    """The reference's ternary secret (HE.cu:690-713), [L, W, n]."""
    out = np.zeros((L, W, n), dtype=np.uint64)
    _lib().mf_ternary_secret(L, W, n, _p(_moduli(moduli, L)), _p(out))
    return out


def gaussian_noise(L: int, W: int, n: int, sigma: float, moduli) -> np.ndarray:
    """The reference's Box-Muller noise (HE.cu:581-627) with native libm,
    [L, W, n, n]."""
    out = np.zeros((L, W, n, n), dtype=np.uint64)
    _lib().mf_gaussian_noise(L, W, n, float(sigma),
                             _p(_moduli(moduli, L)), _p(out))
    return out


def crt_compose_centered(residues, m_tables, inv_tables, moduli, q_big,
                         q_half):
    """One coefficient: its centered CRT composition as (magnitude words,
    little-endian uint64, negative?)."""
    residues, q_big = _u64(residues), _u64(q_big)
    m_tables, inv_tables = _u64(m_tables), _u64(inv_tables)
    moduli, q_half = _u64(moduli), _u64(q_half)
    L, words = residues.size, q_big.size
    if (m_tables.shape != (L, words) or inv_tables.size != L
            or moduli.size != L or q_half.size != words):
        raise ValueError("CRT tables do not match the residues and Q")
    mag = np.zeros(words, dtype=np.uint64)
    neg = _LL(0)
    _lib().mf_crt_compose_centered(
        L, _p(residues), _p(m_tables), _p(inv_tables), _p(moduli), _p(q_big),
        _p(q_half), words, _p(mag), ctypes.byref(neg))
    return mag, bool(neg.value)


def ntt_polymul(q: int, fwd, inv, a, b) -> np.ndarray:
    """inv @ ((fwd @ a) * (fwd @ b)) mod q: a polymul through given
    transform tables."""
    a, b, fwd, inv = _u64(a), _u64(b), _u64(fwd), _u64(inv)
    _same_size(a, b)
    if fwd.shape != (a.size, a.size) or inv.shape != fwd.shape:
        raise ValueError(f"tables {fwd.shape}, {inv.shape} for n = {a.size}")
    out = np.zeros(a.size, dtype=np.uint64)
    _lib().mf_ntt_polymul(q, a.size, _p(fwd), _p(inv), _p(a), _p(b), _p(out))
    return out
