"""matrix_fhe_tpu_torch — the Matrix-FHE framework on PyTorch and CUDA.

The PyTorch port of matrix_fhe_tpu for NVIDIA Hopper (H100).  It packs
phi(p) = 512 complex 64x64 matrices into one RLWE ciphertext pair over an
11-limb RNS chain, like the JAX package, which stays the reference: each
function here computes what its counterpart there computes, held bit for
bit by tests/test_torch_*.py.

  * Residues are int64 tensors of canonical values (< q < 2^56) in the
    limb-major [L, W, n, n] layout.
  * The exact modular matmuls (W-CRT, X-NTT, the fused NTT-multiply-iNTT
    and the fused inverse + CRT compose), the exact fixed-point complex
    matmul, the four-step NTT and the trace GEMM are hand-written CUDA
    kernels (csrc/), each with a plain PyTorch version beside it: a CPU
    tensor takes the plain version, a CUDA tensor the kernel.
  * A context lives on one device: init_he_backend(name, device=...),
    "cuda" unless the caller asks for "cpu" (which runs the plain
    versions of the kernels).
  * Beside the roundtrip: the homomorphic matrix product C = Y^H X
    (HEMatmul, the trace GEMM), its ciphertext-in / ciphertext-out form
    on the gl2 double ring (Gl2Context, HEMatmul2, Gl2GemmRelin: the 2x2
    GEMM tensor and its relinearization, and Gl2Conj, the homomorphic
    complex conjugation) and the large-N four-step NTT
    (ops/ntt_large.FourStepNTT).
  * Key switching: relinearized multiplication, rescale and Galois
    rotations (models/keyswitch.py), and the leveled chains that compose
    them at depth: LeveledChain, and Gl2Chain, whose encrypted GEMM
    products are rescaled and multiplied again on the gl2 ring.
  * parallel/: the sharded programs on torch.distributed, one process a
    rank (the coefficient-sharded four-step NTT, the dp x tp sharded
    roundtrip, the W-sharded key switch and gl2 GEMM), and
    launch.run_world, a world of ranks on one machine; scripts/bench_dist
    runs them.
  * The repo's entry points as programs: examples/ (main, matmul,
    matmul_gl2, relinearize, leveled), scripts/bench (the headline JSON
    line) and entry (entry(), dryrun_multichip(n)).
  * utils/: checkpoints in the JAX package's .npz format
    (serialization), timers (timer), traces (profiler) and logging;
    native/golden, an independent C++ oracle; scripts/rt_phases, the
    roundtrip's phase table on the card.

The package imports torch, numpy and the standard library, never jax.
"""

from .config import GLParams, get_params, REF_PARAMS_NAME  # noqa: F401

__version__ = "0.1.0"

_LAZY = {
    "Ciphertext": ".models.he",
    "SecretKey": ".models.he",
    "HEContext": ".models.he",
    "init_he_backend": ".models.he",
    "HEMatmul": ".models.he_matmul",
    "Gl2Context": ".models.he2",
    "HEMatmul2": ".models.he_matmul2",
    "Gl2Conj": ".models.he_matmul2",
    "Gl2GemmRelin": ".models.he_matmul2",
    "RelinContext": ".models.keyswitch",
    "LeveledChain": ".models.leveled",
    "LeveledCt": ".models.leveled",
    "Gl2Chain": ".models.leveled2",
}


def __getattr__(name):
    if name in _LAZY:
        import importlib

        mod = importlib.import_module(_LAZY[name], __name__)
        return getattr(mod, name)
    raise AttributeError(name)
