"""Build, load and launch the hand-written Hopper kernels.

Every kernel wrapper in the port follows one rule: a CPU tensor takes the
kernel's plain PyTorch version, a CUDA tensor takes the kernel or raises.
There is no switch that picks the plain version for a CUDA tensor.

The kernels live in ``matrix_fhe_tpu_torch/csrc/*.cu`` and are compiled on
first use with ``nvcc -gencode arch=compute_90a,code=sm_90a``, one nvcc
process per source, all started together, then linked into one shared
library with a plain C interface, which ctypes loads.  The library is built
into ``matrix_fhe_tpu_torch/_build/`` and rebuilt when a source is newer
than it.  Each wrapper adds one to ``LAUNCHES[name]`` where it
launches its kernel, so a run can show which kernels its main path used.
"""

from __future__ import annotations

import collections
import ctypes
import functools
import os
import shutil
import subprocess
import tempfile

import torch

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD = os.path.join(_PKG, "_build")
SOURCES = ("stage.cu", "xntt_stage.cu", "wcrt_stage.cu", "ntt_mul_ntt.cu",
           "inv_compose.cu", "fp_cmatmul.cu", "four_step_ntt.cu", "cgemm.cu", "gemm2x2.cu",
           "micro_vpu.cu", "micro_coissue.cu", "base_conv.cu",
           "crt_compose.cu", "gl2_key_products.cu")
HEADERS = ("modarith.cuh", "wgmma8.cuh")
LIBRARY = os.path.join(BUILD, "libmfhe_kernels.so")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC")

# launches per kernel since the last reset (read by chip_smoke.py)
LAUNCHES: collections.Counter = collections.Counter()

_P = ctypes.c_void_p
_I = ctypes.c_int
_LL = ctypes.c_longlong
_D = ctypes.c_double
_SIGNATURES = {
    # name: argtypes after the C function's own name
    "mf_stage": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _LL, _LL,
                 _I, _I, _P],
    "mf_stage_split": [_P, _P, _P, _I, _I, _I, _I, _I, _I, _P],
    "mf_stage_x": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P],
    "mf_stage_w": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P],
    "mf_ntt_mul_ntt": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I,
                       _P],
    "mf_inv_compose": [_P, _P, _P, _P, _P, _I, _LL, _P],
    "mf_fp_split": [_P, _P, _P, _I, _I, _I, _P],
    "mf_fp_cmatmul": [_P, _P, _P, _I, _I, _I, _I, _P],
    "mf_four_step": [_P, _P, _P, _I, _I, _I, _I, _I, _P, _P, _P, _P, _P, _P,
                     _P],
    "mf_cgemm": [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _P],
    "mf_gemm2x2": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P],
    "mf_u32_chain": [_P, _P, _LL, _I, _I, _P],
    "mf_coissue": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I,
                   _P],
    "mf_base_conv": [_P, _P, _P, _P, _P, _I, _I, _LL, _P],
    "mf_crt_compose": [_P, _P, _P, _I, _I, _LL, _D, _P],
    "mf_gl2_key_products": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P],
    "mf_ntt_mul_ntt_smem": [_I],
    "mf_stage_layout": [_I, _I, _I, ctypes.POINTER(_I)],
    "mf_fp_layout": [_I, _I, ctypes.POINTER(_I)],
}
# host-side queries that return something other than a CUDA error code
_RESTYPES = {"mf_ntt_mul_ntt_smem": _LL}


def reset_launches() -> None:
    LAUNCHES.clear()


class Launches:
    """The kernel launches made inside its `with` blocks, summed over them:
    a program's own calls, without its set-up or its checks.

        own = Launches()
        with own:
            y = program(x)
        own.counts()        # {kernel: launches} of program(x) alone
    """

    def __init__(self):
        self._counts = collections.Counter()
        self._before = collections.Counter()

    def __enter__(self) -> "Launches":
        self._before = collections.Counter(LAUNCHES)
        return self

    def __exit__(self, *exc) -> None:
        self._counts.update(LAUNCHES - self._before)

    def counts(self) -> dict:
        return dict(sorted(self._counts.items()))


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def _stale() -> bool:
    if not os.path.exists(LIBRARY):
        return True
    built = os.path.getmtime(LIBRARY)
    return any(os.path.getmtime(os.path.join(CSRC, f)) > built
               for f in SOURCES + HEADERS)


def build() -> str:
    """Compile the kernels if the library is missing or older than a
    source; returns the library path.  Raises with nvcc's output on
    failure."""
    if not _stale():
        return LIBRARY
    os.makedirs(BUILD, exist_ok=True)
    nvcc = _nvcc()
    with tempfile.TemporaryDirectory(dir=BUILD) as tmpdir:
        objs = [os.path.join(tmpdir, f + ".o") for f in SOURCES]
        procs = [subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-I", CSRC, "-c", "-o", obj,
             os.path.join(CSRC, f)],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
            for f, obj in zip(SOURCES, objs)]
        errors = []
        for f, proc in zip(SOURCES, procs):
            _, err = proc.communicate()
            if proc.returncode != 0:
                errors.append(f"{f}: nvcc failed ({proc.returncode}):\n{err}")
        if errors:
            raise RuntimeError("\n".join(errors))
        tmp = os.path.join(tmpdir, "lib.so")
        proc = subprocess.run([nvcc, *NVCC_FLAGS, "-shared", "-o", tmp, *objs],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({proc.returncode}):\n"
                               f"{proc.stderr}")
        os.replace(tmp, LIBRARY)
    return LIBRARY


@functools.cache
def library() -> ctypes.CDLL:
    lib = ctypes.CDLL(build())
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = _RESTYPES.get(name, ctypes.c_int)
    return lib


def resolve_device(device) -> torch.device:
    """An entry point's device; a CUDA device must exist (no CPU fallback)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {dev} requested but CUDA is not available")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {dev}")
    return dev


def on_device(*tensors: torch.Tensor) -> bool:
    """True when the kernel must run (all tensors on one CUDA device),
    False when all lie on the CPU (the plain version runs).  Anything
    else raises."""
    devices = {t.device for t in tensors}
    if len(devices) != 1:
        raise ValueError(f"tensors on several devices: {sorted(map(str, devices))}")
    (dev,) = devices
    if dev.type == "cpu":
        return False
    if dev.type == "cuda":
        return True
    raise ValueError(f"no kernel for device {dev}")


def check(t: torch.Tensor, name: str, dtype: torch.dtype, shape) -> None:
    """Validate a kernel argument before its pointer is passed."""
    if t.dtype != dtype:
        raise TypeError(f"{name}: dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: not contiguous")


def launch(kernel: str, fn_name: str, device: torch.device, *args) -> None:
    """Call the C launcher on the current stream of `device` (tensors are
    passed as their data pointers, None as a null pointer) and raise on a
    nonzero cudaGetLastError(); counts the launch under `kernel`."""
    fn = getattr(library(), fn_name)
    cargs = [a.data_ptr() if isinstance(a, torch.Tensor) else a for a in args]
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = fn(*cargs, stream)
    if err != 0:
        raise RuntimeError(f"{kernel}: kernel launch failed with CUDA error {err}")
    LAUNCHES[kernel] += 1
