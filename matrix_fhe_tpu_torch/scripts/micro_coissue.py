"""K12 probe: do int8 tensor-core dots overlap 32-bit integer work?

    python3 -m matrix_fhe_tpu_torch.scripts.micro_coissue [--reps 8]
        [--grid 64] [--iters 30]

The port of scripts/micro_coissue.py.  Per grid cell: reps int8
[256, 1280] x [1280, 256] dots (int32 sums) and reps rounds of a fold-like
u32 chain on two [256, 256] planes, in six modes (dma, mxu, vpu, both, dep,
dma+mxu; see ops/probes.py).  Each mode is timed over `iters` calls with
CUDA events; prints us per cell and the co-issue fraction

    (mxu + vpu - base - both) / (min(mxu, vpu) - base),

1 for perfect overlap, 0 for serial, with base the dma cell (0 when the dma
cell is slower than a compute cell, as the TPU script does), and the same
fraction for the dependent chain (dep in place of both).  Needs a CUDA
device.
"""

from __future__ import annotations

import argparse
import sys
from typing import Dict

import torch

from ..ops import probes
from ..utils.timing import cuda_ms

N = 256          # tile side
K = 1280         # contraction depth (5 digit planes at radix 256)
PLANES = 2
MODES = ("dma", "mxu", "vpu", "both", "dep", "dma+mxu")


def make_inputs(grid: int, seed: int = 0):
    """d8, t8 in [-100, 100) and u32 planes a, b, made on the card."""
    gen = torch.Generator(device="cuda").manual_seed(seed)

    def ints(lo, hi, shape, dtype):
        return torch.randint(lo, hi, shape, generator=gen, dtype=dtype,
                             device="cuda")

    d8 = ints(-100, 100, (grid, PLANES, N, K), torch.int8)
    t8 = ints(-100, 100, (1, PLANES, K, N), torch.int8)
    a = ints(-(1 << 31), 1 << 31, (grid, N, N), torch.int32)
    b = ints(-(1 << 31), 1 << 31, (grid, N, N), torch.int32)
    return d8, t8, a, b


def baseline(res: Dict[str, float]) -> float:
    """The dma cell, or 0 when it is slower than a compute cell (then it
    is no fixed cost to subtract, as the TPU script decides)."""
    return 0.0 if res["dma"] > min(res["mxu"], res["vpu"]) else res["dma"]


def overlap(res: Dict[str, float], joint: str) -> float:
    mxu, vpu, base = res["mxu"], res["vpu"], baseline(res)
    return (mxu + vpu - base - res[joint]) / max(min(mxu, vpu) - base, 1e-9)


def run(reps: int = 8, grid: int = 64, iters: int = 30) -> Dict:
    d8, t8, a, b = make_inputs(grid)
    per_cell = {}
    for mode in MODES:
        ms = cuda_ms(lambda mode=mode: probes.coissue(d8, t8, a, b, mode,
                                                      reps), iters)
        per_cell[mode] = ms * 1e3 / grid
        print(f"{mode:8s} {per_cell[mode]:8.2f} us/cell   "
              f"({ms:.3f} ms total)", flush=True)
    if per_cell["dma"] > min(per_cell["mxu"], per_cell["vpu"]):
        print(f"[dma cell {per_cell['dma']:.2f} us/cell > compute cells -- "
              "ignoring it as a baseline]", flush=True)
    out = {"us_per_cell": per_cell, "coissue": overlap(per_cell, "both"),
           "dep_overlap": overlap(per_cell, "dep")}
    print(f"co-issue fraction (1 = perfect overlap, 0 = serial): "
          f"{out['coissue']:.2f}; dependent chain: {out['dep_overlap']:.2f}",
          flush=True)
    mxu = per_cell["mxu"] - baseline(per_cell)
    if mxu > 0:
        out["dot_tops"] = reps * N * K * N * 2 / (mxu * 1e-6) / 1e12
        print(f"dots per rep: {N * K * N * 2 / 1e9:.3f} Gop; int8 rate "
              f"~= {out['dot_tops']:.0f} Top/s", flush=True)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--reps", type=int, default=8)
    ap.add_argument("--grid", type=int, default=64)
    ap.add_argument("--iters", type=int, default=30)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("micro_coissue: needs a CUDA device", file=sys.stderr)
        return 2
    print(f"[micro_coissue] {torch.cuda.get_device_name(0)}, reps "
          f"{args.reps}, grid {args.grid}, {args.iters} calls a mode",
          flush=True)
    run(args.reps, args.grid, args.iters)
    return 0


if __name__ == "__main__":
    sys.exit(main())
