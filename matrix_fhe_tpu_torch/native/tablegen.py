"""ctypes binding for the native table generator.

Compiles the port's own copy of the table generator, native/tablegen.cpp
beside this file, with g++ into the port's build directory
matrix_fhe_tpu_torch/_build/ on first use, and rebuilds when the source is
newer than the library.  `available()` is False where no compiler is
found; matrix_fhe_tpu_torch.tables then uses its pure-Python code,
which is also the oracle the tests compare against.  The root searches
find_eta and find_psi4n are the native functions themselves: they raise
where the library cannot be built (tables.py finds its roots in Python).
"""

from __future__ import annotations

import ctypes
import functools
import os
import subprocess
import tempfile
from typing import Sequence, Tuple

import numpy as np

_PORT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE = os.path.join(_PORT, "native", "tablegen.cpp")
LIBRARY = os.path.join(_PORT, "_build", "libtablegen.so")

_PU64 = ctypes.POINTER(ctypes.c_uint64)
_PI64 = ctypes.POINTER(ctypes.c_int64)


def build_library(source: str, library: str) -> str:
    """g++ `source` into the shared library `library` unless it is newer
    than its source; the build goes through a temporary file, so a
    concurrent process never loads half a library."""
    if (os.path.exists(library)
            and os.path.getmtime(library) >= os.path.getmtime(source)):
        return library
    os.makedirs(os.path.dirname(library), exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=os.path.dirname(library))
    os.close(fd)
    try:
        subprocess.run(["g++", "-O3", "-shared", "-fPIC", "-o", tmp, source],
                       check=True, capture_output=True, timeout=120)
        os.replace(tmp, library)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return library


@functools.cache
def _lib():
    """The loaded library, or None when it cannot be built or loaded."""
    try:
        lib = ctypes.CDLL(build_library(SOURCE, LIBRARY))
    except (OSError, subprocess.SubprocessError):
        return None
    lib.mf_vandermonde.argtypes = [ctypes.c_uint64, _PU64, ctypes.c_int64,
                                   _PU64]
    lib.mf_vandermonde.restype = None
    lib.mf_lagrange_inverse.argtypes = [ctypes.c_uint64, _PU64,
                                        ctypes.c_int64, _PI64, _PU64]
    lib.mf_lagrange_inverse.restype = None
    lib.mf_find_eta.argtypes = [ctypes.c_uint64] * 4
    lib.mf_find_eta.restype = ctypes.c_uint64
    lib.mf_find_psi4n.argtypes = [ctypes.c_uint64] * 2
    lib.mf_find_psi4n.restype = ctypes.c_uint64
    return lib


def available() -> bool:
    return _lib() is not None


def _native():
    lib = _lib()
    if lib is None:
        raise RuntimeError(f"the native table generator could not be built "
                           f"from {SOURCE} (g++ missing?)")
    return lib


def wcrt_tables(q: int, roots: Sequence[int], master: Sequence[int]
                ) -> Tuple[np.ndarray, np.ndarray]:
    """(V, V^-1) mod q for evaluation points `roots` of the monic `master`."""
    lib = _native()
    phi = len(roots)
    r = np.ascontiguousarray(roots, dtype=np.uint64)
    m = np.ascontiguousarray(master, dtype=np.int64)
    if m.shape[0] != phi + 1:
        raise ValueError("master polynomial must have degree len(roots)")
    v = np.empty((phi, phi), dtype=np.uint64)
    vi = np.empty((phi, phi), dtype=np.uint64)
    lib.mf_vandermonde(q, r.ctypes.data_as(_PU64), phi, v.ctypes.data_as(_PU64))
    lib.mf_lagrange_inverse(q, r.ctypes.data_as(_PU64), phi,
                            m.ctypes.data_as(_PI64), vi.ctypes.data_as(_PU64))
    return v, vi


def find_eta(q: int, p: int, f1: int, f2: int) -> int:
    """Order-p root of unity mod q (h_find_eta, HE.cu:119-133), searched
    by the C++; ValueError where it finds none."""
    out = _native().mf_find_eta(q, p, f1, f2)
    if out == 0:
        raise ValueError("native find_eta failed")
    return int(out)


def find_psi4n(q: int, n: int) -> int:
    """Order-4n root psi with psi^(2n) == -1 mod q (get_psi,
    ntt_core.cu:49-70), searched by the C++; ValueError where
    (q - 1) mod 4n != 0 or the search finds none."""
    out = _native().mf_find_psi4n(q, n)
    if out == 0:
        raise ValueError("native find_psi4n failed")
    return int(out)
