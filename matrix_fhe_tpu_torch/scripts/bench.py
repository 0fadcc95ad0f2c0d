"""Headline benchmark: N = 2^16 NTTs a second on the card, and the ref gate.

    python3 -m matrix_fhe_tpu_torch.scripts.bench [--batch 128] [--iters 40]
        [--device cpu]

Counterpart of bench.py in the JAX package.  It prints one JSON line with
its keys:

  value               NTT/s of FourStepNTT.forward at N = 2^16, L = 16
                      35-bit primes (generate_primes_1mod), B = --batch
                      polynomials of default_rng(0) residues: L B over the
                      mean time of --iters chained forwards (the output
                      feeds the next call), after one untimed chain of as
                      many (K5): the first chain finds the caching
                      allocator's 1 GB buffers (path 2 of chip_smoke.py
                      times it at ~0.75 of the steady rate);
  vs_baseline         value over BASELINE.json's 1,000,000;
  ntt_28bit_per_sec   the same at 28-bit primes (the input continues the
                      stream), max(10, iters / 2) chained forwards;
  ref_roundtrip_ms    HEContext.roundtrip at ref on default_rng(7)
                      uniform(-4, 4) messages, the mean of 5 calls after
                      the first (K1-K4);
  ref_roundtrip_err   its max error, < 1e-4 (src/main.cu:150);
  device              the card's name and power limit as nvidia-smi
                      --query-gpu=name,power.limit --format=csv,noheader
                      prints them.

Each NTT row is fenced by inverse(forward(x)) == x on the whole batch.
Times come from CUDA events on the card, from the host clock with
--device cpu (the plain versions; a test's run, never a device figure).
Unlike the JAX script, nothing is swallowed: a failed fence or gate
raises, the run exits nonzero and prints no JSON line.  The TPU schedule
sweep (BENCH_IMPL, BENCH_AUTOVAR) has no counterpart here.  Progress
goes to stderr; the script also prints {"launches": {...}}, the kernels
that its timed forwards and its ref roundtrips launched (not the fence's
nor the set-up's).
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time

import numpy as np
import torch

from ..config import generate_primes_1mod, get_params
from ..examples import print_launches
from ..examples.main import tolerance
from ..models.he import init_he_backend
from ..ops import _backend as be
from ..ops._backend import Launches
from ..ops.ntt_large import FourStepNTT, FourStepPlan
from ..utils.timing import clock, cuda_ms

METRIC = "NTTs/sec/chip (N=2^16, L=16, negacyclic, 35-bit primes)"
NTT_N, NTT_L = 1 << 16, 16      # bench.py:94-95
GATE_PRESET = "ref"
BASELINE = 1_000_000.0          # BASELINE.json: NTT/s a chip at N = 2^16
CARD_QUERY = ["nvidia-smi", "--query-gpu=name,power.limit",
              "--format=csv,noheader"]
GATE_CALLS = 5


def _mean_ms(fn, iters: int, device: torch.device, chain=None) -> float:
    """Mean ms a call of `iters` calls of fn(), or with `chain` of chained
    calls y = fn(y) from y = chain: CUDA events on the card, the host clock
    on the CPU."""
    if device.type == "cuda":
        return cuda_ms(fn, iters, warmup=False, chain=chain)
    t0 = time.perf_counter()
    y = chain
    for _ in range(iters):
        y = fn() if chain is None else fn(y)
    return 1e3 * (time.perf_counter() - t0) / iters


def _log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def ntt_row(bits: int, batch: int, iters: int, rng: np.random.Generator,
            device: torch.device, own: Launches) -> float:
    """NTT/s of chained forwards at one prime width (their launches
    counted in `own`), behind the exact roundtrip fence; raises when the
    fence fails."""
    n, limbs = NTT_N, NTT_L
    primes = generate_primes_1mod(limbs, bits, 2 * n)
    ntt = FourStepNTT(FourStepPlan.make(n, primes), device)
    x = torch.from_numpy(np.stack(
        [rng.integers(0, q, size=(batch, n), dtype=np.uint64)
         for q in primes]).view(np.int64)).to(device)
    with own:
        first = _mean_ms(ntt.forward, iters, device, x)
        ms = _mean_ms(ntt.forward, iters, device, x)
    _log(f"[bench] {bits}-bit: first chain {first:.3f} ms a forward")
    rate = limbs * batch / (ms / 1e3)
    _log(f"[bench] {bits}-bit: forward {ms:.3f} ms for {limbs * batch} NTTs "
         f"({rate:,.0f}/s)")
    if not torch.equal(ntt.inverse(ntt.forward(x)), x):
        raise RuntimeError(f"NTT roundtrip mismatch ({bits}-bit)")
    return rate


def ref_gate(preset: str, device: torch.device, own: Launches) -> dict:
    """The ref roundtrip's mean ms over GATE_CALLS calls after the first,
    and its max error (the roundtrips' launches counted in `own`); raises
    past the tolerance (1e-4 at ref)."""
    p = get_params(preset)
    t0 = time.perf_counter()
    ctx = init_he_backend(preset, device=device)
    sk = ctx.generate_secret_key()
    r = np.random.default_rng(7)
    re = torch.from_numpy(r.uniform(-4, 4, size=(p.phi, p.n, p.n))).to(device)
    im = torch.from_numpy(r.uniform(-4, 4, size=(p.phi, p.n, p.n))).to(device)
    with own:
        ctx.roundtrip(re, im, sk)
        first_s = clock(device) - t0
        rt_ms = _mean_ms(lambda: ctx.roundtrip(re, im, sk), GATE_CALLS,
                         device)
        dr, di = ctx.roundtrip(re, im, sk)
    err = float(torch.hypot(dr - re, di - im).max())
    tol = tolerance(p.delta)
    _log(f"[bench] {preset} roundtrip: {rt_ms:.3f} ms, err {err:.3e} (limit "
         f"{tol:g}; setup + first call {first_s:.1f}s)")
    if not err < tol:
        raise RuntimeError(f"{preset} pipeline err {err} >= {tol}")
    return {"ref_roundtrip_ms": rt_ms, "ref_roundtrip_err": err}


def card() -> str:
    """The card's name and power limit, as nvidia-smi prints them."""
    return subprocess.run(CARD_QUERY, check=True, capture_output=True,
                          text=True).stdout.strip()


def run(batch: int = 128, iters: int = 40, device="cuda") -> dict:
    """The bench's JSON object and its launches; raises on a failed check."""
    dev = be.resolve_device(device)
    own = Launches()
    rng = np.random.default_rng(0)
    rate = ntt_row(35, batch, iters, rng, dev, own)
    rate28 = ntt_row(28, batch, max(10, iters // 2), rng, dev, own)
    out = {"metric": METRIC, "value": rate, "unit": "NTT/s",
           "vs_baseline": rate / BASELINE, "ntt_28bit_per_sec": rate28}
    out.update(ref_gate(GATE_PRESET, dev, own))
    out["device"] = card() if dev.type == "cuda" else \
        "cpu (plain versions, not a device figure)"
    return {"result": out, "launches": own.counts()}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batch", type=int, default=128,
                    help="polynomials a limb (JAX: BENCH_BATCH)")
    ap.add_argument("--iters", type=int, default=40,
                    help="chained forwards timed (JAX: BENCH_ITERS)")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)
    res = run(args.batch, args.iters, args.device)
    print_launches(res["launches"])
    print(json.dumps(res["result"]), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
