"""The repository's example programs, on the port.

Each module is the counterpart of one script under examples/ in the JAX
package: the same flow, input pattern, default preset and pass
criterion.  Each exposes

  run(preset, device, ...) -> dict   the run, printing the JAX script's
                                     progress lines; returns what the
                                     script prints (errors, noise,
                                     timings) and `launches`, the kernel
                                     launches of the program's own calls
                                     (ops._backend.Launches), not of its
                                     set-up, keys, encryptions or its
                                     checks' oracles and baselines;
  main(argv) -> int                  run() and the script's result lines,
                                     0 on pass, 1 on fail;

and runs as a program:

    python -m matrix_fhe_tpu_torch.examples.main [preset] [--device cpu]
    python -m matrix_fhe_tpu_torch.examples.matmul [preset]
    python -m matrix_fhe_tpu_torch.examples.matmul_gl2 [preset] [--auto-p]
    python -m matrix_fhe_tpu_torch.examples.relinearize [preset] [--auto-p]
    python -m matrix_fhe_tpu_torch.examples.leveled [preset]

Every program runs on the card ("cuda") unless given --device cpu, which
runs the kernels' plain versions; without CUDA it raises.  Each prints one
line {"launches": {...}} beside its own lines.
"""

from __future__ import annotations

import argparse
import json

import numpy as np


def parser(description: str, preset: str) -> argparse.ArgumentParser:
    """The programs' command line: [preset] [--device cuda|cpu]."""
    ap = argparse.ArgumentParser(description=description)
    ap.add_argument("preset", nargs="?", default=preset)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="cpu runs the kernels' plain versions")
    return ap


def complex_pair(p, seed: int = 7):
    """Two [phi, n, n] complex matrices of default_rng(seed)
    uniform(-1, 1) (the first's real and imaginary parts, then the
    second's): the matmul scripts' inputs."""
    rng = np.random.default_rng(seed)
    shape = (p.phi, p.n, p.n)
    return tuple(rng.uniform(-1, 1, shape) + 1j * rng.uniform(-1, 1, shape)
                 for _ in range(2))


def print_launches(launches: dict) -> None:
    print(json.dumps({"launches": launches}), flush=True)
