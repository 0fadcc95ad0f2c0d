"""Key-switch phase table: multiply_relinearize split into its steps.

    python3 -m matrix_fhe_tpu_torch.scripts.ks_phases [preset] [iters]
        [--p-basis preset|auto]

The port of scripts/ks_phases.py on the card.  One ciphertext of small
limb-consistent integers (< 2^20) is multiplied by itself and
relinearized; the phases are the port's one route:

  front:   the tensor product (X-NTTs fused with the products, K10a) and
           the W-CRT inverse of d2
  digit i: basis extension of limb group i to QP, W-CRT over QP, the
           X-NTT fused with both key products (K10a), accumulation
  finish:  the inverse QP transforms, ModDown to Q, W-CRT forward, adds

each the mean of `iters` calls between CUDA events after a warm-up, and
the whole multiply_relinearize.  `--p-basis auto` takes the JAX package's
generated P basis instead of the preset's (RelinContext(p_moduli="auto")).
Prints the P basis and dnum.  Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import sys
from typing import Dict

import numpy as np
import torch

from ..config import get_params
from ..models import rng as refrng
from ..models.he import HEContext
from ..models.keyswitch import RelinContext
from ..utils.timing import cuda_ms


def run(preset: str = "mid", iters: int = 5, p_basis: str = "preset"
        ) -> Dict:
    p = get_params(preset)
    ctx = HEContext(p, ring="nega", device="cuda")
    rc = RelinContext(ctx, p_moduli="auto" if p_basis == "auto" else None)
    print(f"[ks] {preset}: P basis {[q.bit_length() for q in rc.p_moduli]} "
          f"bits, dnum={rc.dnum}, groups {rc.groups}", flush=True)
    dev = ctx.device
    sk = ctx.generate_secret_key()
    rlk = rc.gen_relin_key(refrng.ternary_secret(p, dev),
                           torch.Generator(device=dev).manual_seed(5))
    c = np.random.default_rng(0).integers(0, 1 << 20, (p.phi, p.n, p.n))
    coeffs = torch.stack([torch.from_numpy(c % int(q)) for q in p.moduli])
    ct = ctx.encrypt(ctx.wt.forward(coeffs.to(dev)), sk)

    out = {"preset": preset, "p_basis": p_basis,
           "p_bits": [q.bit_length() for q in rc.p_moduli], "dnum": rc.dnum}
    out["multiply_relinearize_ms"] = cuda_ms(
        lambda: rc.multiply_relinearize(ct, ct, rlk), iters)
    print(f"multiply_relinearize: {out['multiply_relinearize_ms']:10.3f} ms",
          flush=True)
    d0c, d1c, d2wc = rc._mr_front(ct, ct)
    out["front_ms"] = cuda_ms(lambda: rc._mr_front(ct, ct), iters)
    print(f"front (tensor product + W-CRT inverse): {out['front_ms']:10.3f} ms",
          flush=True)
    ksb = ksa = None
    out["digit_ms"] = []
    for i in range(rc.dnum):
        ms = cuda_ms(lambda i=i, b=ksb, a=ksa: rc._digit_step(
            i, d2wc, rlk.b[i], rlk.a[i], b, a), iters)
        out["digit_ms"].append(ms)
        print(f"digit {i} (extend + QP W-CRT + NTT x key): {ms:10.3f} ms",
              flush=True)
        ksb, ksa = rc._digit_step(i, d2wc, rlk.b[i], rlk.a[i], ksb, ksa)
    out["finish_ms"] = cuda_ms(lambda: rc._mr_finish(d0c, d1c, ksb, ksa),
                              iters)
    print(f"finish (QP inverse + ModDown + W-CRT): {out['finish_ms']:10.3f} ms",
          flush=True)
    print(f"digits total: {sum(out['digit_ms']):.3f} ms over {rc.dnum} digits",
          flush=True)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("preset", nargs="?", default="mid")
    ap.add_argument("iters", nargs="?", type=int, default=5)
    ap.add_argument("--p-basis", choices=("preset", "auto"), default="preset")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("ks_phases: needs a CUDA device", file=sys.stderr)
        return 2
    print(f"[ks] {torch.cuda.get_device_name(0)}", flush=True)
    run(args.preset, args.iters, args.p_basis)
    return 0


if __name__ == "__main__":
    sys.exit(main())
