"""Full-pipeline demo: the reference binary's flow on the port.

    python -m matrix_fhe_tpu_torch.examples.main [preset] [--device cpu]

Counterpart of examples/main.py (src/main.cu:31-157 of the reference):
the deterministic input msg[ell][i] = ell + i 1e-5 + (ell - i 1e-5) j
(main.cu:62-67), encode (K4, K1), encrypt_pair (K2), decrypt_and_decode
(K2, K3, K4), and the global max |error| < 1e-4 at Delta = 2^35
(main.cu:150); 0.05 at Delta >= 2^25 and 0.5 below, as the JAX script.
Default preset: ref.
"""

from __future__ import annotations

import sys
import time
from typing import Tuple

import numpy as np
import torch

from ..config import get_params
from ..models.he import HEContext, SecretKey, init_he_backend
from ..ops._backend import Launches
from ..utils.timing import clock
from . import parser, print_launches


def message(p) -> Tuple[np.ndarray, np.ndarray]:
    """(re, im) [phi, n, n]: msg[ell][i] = ell + i 1e-5 + (ell - i 1e-5) j."""
    n2 = p.n * p.n
    ell = np.arange(p.phi, dtype=np.float64)[:, None]
    i = np.arange(n2, dtype=np.float64)[None, :]
    return ((ell + i * 1e-5).reshape(p.phi, p.n, p.n),
            (ell - i * 1e-5).reshape(p.phi, p.n, p.n))


def tolerance(delta: float) -> float:
    """1e-4 at the reference Delta = 2^35 (main.cu:150); the scaled
    presets' proportionally looser bounds."""
    return 1e-4 if delta >= 2 ** 35 else (0.05 if delta >= 2 ** 25 else 0.5)


def steps(ctx: HEContext, sk: SecretKey, re: torch.Tensor, im: torch.Tensor
          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Step A encode, step B encrypt, step C decrypt + decode."""
    print(">>> Step A: Encode...")
    pr, pi = ctx.batched_encoder.encode_to_wntt_eval(re, im)
    print(">>> Step B: Encrypt...")
    ct_re, ct_im = ctx.encrypt_pair(pr, pi, sk)
    print(">>> Step C: Decrypt + Decode...")
    return ctx.decrypt_and_decode(ct_re, ct_im, sk)


def run(preset: str = "ref", device="cuda") -> dict:
    p = get_params(preset)
    t0 = time.perf_counter()
    ctx = init_he_backend(preset, device=device)
    dev = ctx.device
    print(f">>> Initializing backend ({preset}: n={p.n}, phi={p.phi}, "
          f"L={p.num_limbs}, Delta=2^{int(np.log2(p.delta))}) on {dev}...")
    backend_s = clock(dev) - t0
    print(f"    backend ready in {backend_s:.1f}s")
    print(">>> Generating Secret Key...")
    sk = ctx.generate_secret_key()
    print(">>> Generating Input Data...")
    re, im = message(p)
    re_t, im_t = torch.from_numpy(re).to(dev), torch.from_numpy(im).to(dev)
    own = Launches()
    t0 = clock(dev)
    with own:
        dr, di = steps(ctx, sk, re_t, im_t)
    steps_s = clock(dev) - t0
    print(">>> Verifying results...")
    dr, di = dr.cpu().numpy(), di.cpu().numpy()
    err = np.hypot(dr - re, di - im)
    n2 = p.n * p.n
    b, idx = divmod(int(err.argmax()), n2)
    tol = tolerance(p.delta)
    max_err = float(err.max())
    return {"preset": preset, "device": str(dev), "max_err": max_err,
            "worst": {"batch": b, "index": idx,
                      "exp": [float(re.reshape(-1, n2)[b, idx]),
                              float(im.reshape(-1, n2)[b, idx])],
                      "got": [float(dr.reshape(-1, n2)[b, idx]),
                              float(di.reshape(-1, n2)[b, idx])]},
            "tol": tol, "ok": bool(np.isfinite(err).all() and max_err < tol),
            "backend_s": backend_s, "steps_s": steps_s,
            "launches": own.counts()}


def main(argv=None) -> int:
    args = parser(__doc__.splitlines()[0], "ref").parse_args(argv)
    res = run(args.preset, args.device)
    w = res["worst"]
    print(f"Global Max Error: {res['max_err']:.6e}")
    print(f"Worst case at Batch {w['batch']}, Index {w['index']}")
    print(f"  Exp: {w['exp'][0]} + {w['exp'][1]}i")
    print(f"  Got: {w['got'][0]} + {w['got'][1]}i")
    print(f"    encode + encrypt + decrypt + decode {res['steps_s']:.3f}s "
            f"(first call)")
    print_launches(res["launches"])
    print("SUCCESS" if res["ok"] else "FAILURE", f"(threshold {res['tol']:g})")
    return 0 if res["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
