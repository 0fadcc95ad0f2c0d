"""K11 probe: u32 op-chain throughput and copy bandwidth on the card.

    python3 -m matrix_fhe_tpu_torch.scripts.micro_vpu [--iters 30]
        [--shape 16 128 256 256]

The port of scripts/micro_vpu.py: the same variant list over one
[L, B, N1, N2] u32 array (the NTT bench's footprint), each variant called
`iters` times in a chain (y = f(y)) between two CUDA events.  Prints per
variant the ms per call, GB/s (one read and one write of every element)
and T int32-ops/s, counting the operations as the TPU probe does (addmul
2 a step, shift and cmpadd 3).  Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import sys
from typing import Dict, List, Sequence

import torch

from ..ops import probes
from ..utils.timing import cuda_ms

VARIANTS = (("copy", 0), ("addmul", 32), ("addmul", 128), ("shift", 128),
            ("cmpadd", 48), ("addmul", 512))
OPS_PER_STEP = {"copy": 0, "addmul": 2, "shift": 3, "cmpadd": 3}


def random_u32(shape: Sequence[int], seed: int) -> torch.Tensor:
    """Uniform u32 values (as int32 bits) made on the card from a seed."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    return torch.randint(-(1 << 31), 1 << 31, tuple(shape), generator=gen,
                         dtype=torch.int32, device="cuda")


def run(shape: Sequence[int] = (16, 128, 256, 256), iters: int = 30
        ) -> List[Dict]:
    x = random_u32(shape, 0)
    el = x.numel()
    cells = shape[0] * shape[1]
    rows = []
    for kind, k in VARIANTS:
        ms = cuda_ms(lambda v, kind=kind, k=k: probes.u32_chain(v, kind, k),
                     iters, chain=x)
        s = ms / 1e3
        row = {"kind": kind, "k": k, "ms": ms,
               "gb_per_s": 2 * 4 * el / s / 1e9,
               "tops_i32": OPS_PER_STEP[kind] * k * el / s / 1e12,
               "us_per_cell": ms * 1e3 / cells}
        print(f"{kind:8s} k={k:4d}: {ms:8.3f} ms  {row['gb_per_s']:7.1f} GB/s  "
              f"{row['tops_i32']:7.3f} Tops(i32)  "
              f"{row['us_per_cell']:6.2f} us/cell", flush=True)
        rows.append(row)
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--iters", type=int, default=30)
    ap.add_argument("--shape", type=int, nargs=4, default=[16, 128, 256, 256])
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("micro_vpu: needs a CUDA device", file=sys.stderr)
        return 2
    print(f"[micro_vpu] {torch.cuda.get_device_name(0)}, shape {args.shape}, "
          f"{args.iters} chained calls a variant", flush=True)
    run(args.shape, args.iters)
    return 0


if __name__ == "__main__":
    sys.exit(main())
