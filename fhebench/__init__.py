"""The benchmark of matrix_fhe_tpu_torch on one NVIDIA H100: see run.py,
and PERF.md at the root of the repository for its cells and metrics."""
