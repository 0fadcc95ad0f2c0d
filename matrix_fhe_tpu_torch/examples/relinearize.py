"""Relinearized homomorphic multiplication.

    python -m matrix_fhe_tpu_torch.examples.relinearize [preset] [--auto-p]
        [--device cpu]

Counterpart of examples/relinearize.py: the reference-parity secret key,
a relinearization key over the P basis (generator seeded 5, where the JAX
script takes jax.random.key(5)), two messages of default_rng(9) integers
below 2^30 (every limb of the first, then of the second), encrypted on the
parity streams; multiply_relinearize (the tensor product and the digit
steps: K10a's twiddle form, K1), and the relinearization noise, max
|centered| limb-0 W-coefficient of dec(ct) - dec(ct1) dec(ct2), < 2^25
(a check: its decrypts' K2 stays out of the launches line, which counts
the multiplies alone).  The JAX script's MFHE_RELIN_STREAM chooses between its
fused and streamed multiplies; both give the same bits, and the port has
one route (RelinContext.multiply_relinearize, front, one step a digit,
finish), which the script names.  --auto-p takes the generated P basis
(RelinContext p_moduli="auto"), the JAX script's MFHE_AUTO_P=1.  Default
preset: mid.
"""

from __future__ import annotations

import sys
import time

import numpy as np
import torch

from ..config import get_params
from ..models import rng as refrng
from ..models.he import HEContext
from ..models.keyswitch import RelinContext
from ..ops._backend import Launches
from ..utils.debug import relin_noise
from ..utils.timing import clock
from . import parser, print_launches

ROUTE = ("one route: front, one step a digit, finish "
         "(RelinContext.multiply_relinearize; the JAX fused and streamed "
         "multiplies give its bits)")
ITERS = 3   # the steady-state calls, as the JAX script


def messages(p):
    """Two [L, phi, n, n] int64 messages of default_rng(9) integers below
    2^30, limb after limb."""
    rng = np.random.default_rng(9)
    return [torch.from_numpy(np.stack(
        [rng.integers(0, 1 << 30, size=(p.phi, p.n, p.n)) for _ in p.moduli]))
        for _ in range(2)]


def run(preset: str = "mid", device="cuda", auto_p: bool = False) -> dict:
    p = get_params(preset)
    print(f"[relin] preset={preset}: n={p.n}, phi={p.phi}, L={len(p.moduli)}, "
          f"P primes={list(p.p_moduli) or 'generated'}")
    t0 = time.perf_counter()
    ctx = HEContext(p, ring="nega", device=device)
    dev = ctx.device
    rc = RelinContext(ctx, p_moduli="auto" if auto_p else None)
    sk = ctx.generate_secret_key()
    rlk = rc.gen_relin_key(refrng.ternary_secret(p, dev),
                           torch.Generator(device=dev).manual_seed(5))
    init_s = clock(dev) - t0
    print(f"[relin] init+keygen {init_s:.1f}s  (dnum={rc.dnum}, "
          f"groups={rc.groups})")
    m1, m2 = (m.to(dev) for m in messages(p))
    ct1, ct2 = ctx.encrypt(m1, sk), ctx.encrypt(m2, sk)
    print(f"[relin] path = {ROUTE}")
    own = Launches()
    t0 = clock(dev)
    with own:
        ct = rc.multiply_relinearize(ct1, ct2, rlk)
    first_s = clock(dev) - t0
    print(f"[relin] multiply+relinearize {first_s:.1f}s (first call)")
    t0 = clock(dev)
    with own:
        for _ in range(ITERS):
            ct = rc.multiply_relinearize(ct1, ct2, rlk)
    steady_ms = 1e3 * (clock(dev) - t0) / ITERS
    print(f"[relin] steady-state multiply+relinearize {steady_ms:.1f} ms")
    noise = relin_noise(ctx, ct, ct1, ct2, sk)
    return {"preset": preset, "device": str(dev), "auto_p": auto_p,
            "dnum": rc.dnum, "route": ROUTE, "init_s": init_s,
            "first_s": first_s, "steady_ms": steady_ms, "noise": noise,
            "delta_bits": int(np.log2(p.delta)), "limit": 1 << 25,
            "ok": bool(noise < 1 << 25), "launches": own.counts()}


def main(argv=None) -> int:
    ap = parser(__doc__.splitlines()[0], "mid")
    ap.add_argument("--auto-p", action="store_true",
                    help="the generated P basis (RelinContext p_moduli='auto')")
    args = ap.parse_args(argv)
    res = run(args.preset, args.device, args.auto_p)
    delta = 2.0 ** res["delta_bits"]
    print(f"[relin] |relinearization noise| max = {res['noise']} "
            f"(Delta = 2^{res['delta_bits']}; noise/Delta = "
            f"{res['noise'] / delta:.2e})")
    print_launches(res["launches"])
    print("[relin] PASS" if res["ok"] else "[relin] FAIL")
    return 0 if res["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
