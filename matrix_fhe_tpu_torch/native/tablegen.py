"""ctypes binding for the native table generator.

Compiles the port's own copy of the table generator, native/tablegen.cpp
beside this file, with g++ into the port's build directory
matrix_fhe_tpu_torch/_build/ on first use, and rebuilds when the source is
newer than the library.  `available()` is False where no compiler is
found; matrix_fhe_tpu_torch.tables then uses its pure-Python code,
which is also the oracle the tests compare against.
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
    return lib


def available() -> bool:
    return _lib() is not None


def wcrt_tables(q: int, roots: Sequence[int], master: Sequence[int]
                ) -> Tuple[np.ndarray, np.ndarray]:
    """(V, V^-1) mod q for evaluation points `roots` of the monic `master`."""
    lib = _lib()
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
