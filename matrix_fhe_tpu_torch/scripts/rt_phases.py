"""Phase table of the roundtrip on the card.

    python3 -m matrix_fhe_tpu_torch.scripts.rt_phases [preset] [iters]

The port of scripts/rt_phases.py (default: ref 5).  Each phase of
HEContext.roundtrip runs alone, through the very functions the roundtrip
calls, timed by utils.timer.benchmark (CUDA events, one synchronize after
the last of `iters` calls, after two warm-up calls):

  encode:  BatchedEncoder.encode_to_wntt_eval (K4, K1)
  mul_s:   t = a*s, the product encrypt and decrypt share (K2)
  combine: b = m - t + e and ev = b + t for both halves (elementwise adds)
  decode:  BatchedEncoder.decode_from_wntt_eval (K3, K4)

then the fused HEContext.roundtrip and its error against the 1e-4 contract
(src/main.cu:150).  The phases need not sum to the fused time: the split
view runs each phase's launches back to back with its own warm-up, and the
roundtrip's host work between launches is what hides or shows.  The sum is
printed beside the fused time.
"""

from __future__ import annotations

import sys
from typing import Dict

import numpy as np
import torch

from ..config import get_params
from ..models.he import init_he_backend
from ..utils.timer import benchmark

TOL = 1e-4


def run(preset: str = "ref", iters: int = 5, device="cuda") -> Dict:
    """The phase table at `preset`: milliseconds per phase, their sum, the
    fused roundtrip and its max error.  Prints one [rt-phases] line a row."""
    p = get_params(preset)
    ctx = init_he_backend(preset, device=device)
    be = ctx.batched_encoder
    dev = ctx.device
    sk = ctx.generate_secret_key()
    rng = np.random.default_rng(7)
    m_re = torch.from_numpy(rng.uniform(-500, 500, (p.phi, p.n, p.n))).to(dev)
    m_im = torch.from_numpy(rng.uniform(-500, 500, (p.phi, p.n, p.n))).to(dev)

    a_eval = ctx._parity_a_eval
    # real intermediates once
    pr, pi = be.encode_to_wntt_eval(m_re, m_im)
    t = ctx.xntt.mul_s(a_eval, sk.s_mont)
    evs = ctx._roundtrip_combine(pr, pi, t)

    ms = {
        "encode": benchmark(be.encode_to_wntt_eval, m_re, m_im, iters=iters),
        "mul_s (a*s, shared by encrypt and decrypt)": benchmark(
            ctx.xntt.mul_s, a_eval, sk.s_mont, iters=iters),
        "combine (b and ev adds)": benchmark(
            ctx._roundtrip_combine, pr, pi, t, iters=iters),
        "decode": benchmark(be.decode_from_wntt_eval, *evs, iters=iters),
    }
    ms = {k: v * 1e3 for k, v in ms.items()}
    phase_sum = sum(ms.values())
    fused = 1e3 * benchmark(ctx.roundtrip, m_re, m_im, sk, iters=iters)
    dr, di = ctx.roundtrip(m_re, m_im, sk)
    err = float(torch.hypot(dr - m_re, di - m_im).max())
    width = max(len(k) for k in ms)
    for k, v in ms.items():
        print(f"[rt-phases] {k:<{width}} {v:9.3f} ms", flush=True)
    print(f"[rt-phases] {'sum of the phases':<{width}} {phase_sum:9.3f} ms",
          flush=True)
    print(f"[rt-phases] {'fused roundtrip':<{width}} {fused:9.3f} ms",
          flush=True)
    print(f"[rt-phases] roundtrip err {err:.3e} (contract {TOL:g}, "
          f"src/main.cu:150)", flush=True)
    return {"preset": preset, "iters": iters, "phase_ms": ms,
            "phase_sum_ms": phase_sum, "fused_ms": fused, "err": err}


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    preset = argv[0] if argv else "ref"
    iters = int(argv[1]) if len(argv) > 1 else 5
    if not torch.cuda.is_available():
        print("rt_phases: needs a CUDA device", file=sys.stderr)
        return 2
    print(f"[rt-phases] {torch.cuda.get_device_name(0)}, preset {preset}, "
          f"{iters} iterations", flush=True)
    run(preset, iters)
    return 0


if __name__ == "__main__":
    sys.exit(main())
