"""Ciphertext-in / ciphertext-out homomorphic matrix multiplication (gl2).

    python -m matrix_fhe_tpu_torch.examples.matmul_gl2 [preset] [--auto-p]
        [--device cpu]

Counterpart of examples/matmul_gl2.py: in the gl2 double ring
(Gl2Context), encrypt two batches of phi packed n x n complex matrices
from default_rng(7) (X, then Y), run the 2D trace-GEMM tensor (HEMatmul2:
K7), relinearize it with the GemmRelinKey pair (Gl2GemmRelin: K1 in its
W-CRTs and 2D X-NTTs, the key products elementwise) into a standard
ciphertext, and decrypt it with the plain key and decode at Delta^2 (K2
at 2n points, K1, K4).  The pass criterion is the JAX script's: max error
< 2 base_err + 0.1, base_err the two-sided opening's of the raw tensor
(a check: the launches line counts the GEMM calls and the decrypt and
decode of their output, not this baseline).
Generators seeded 1 (key), 9 (switch keys), 2 and 4 (encryptions), where
the JAX script takes jax.random.key(1), key(9), key(2), key(4).
--auto-p relinearizes over RelinContext(ctx, p_moduli="auto"), the JAX
script's MFHE_AUTO_P=1.  Default preset: mid.
"""

from __future__ import annotations

import sys
import time

import numpy as np
import torch

from ..config import get_params
from ..models.he2 import Gl2Context
from ..models.he_matmul2 import Gl2GemmRelin, HEMatmul2
from ..models.keyswitch import RelinContext
from ..ops._backend import Launches
from ..utils.timing import clock
from . import complex_pair, parser, print_launches

ITERS = 3   # the steady-state calls, as the JAX script


def _max_err(dr: torch.Tensor, di: torch.Tensor, C: np.ndarray) -> float:
    return float(np.hypot(dr.cpu().numpy() - C.real,
                          di.cpu().numpy() - C.imag).max())


def baseline_err(ctx: Gl2Context, hm: HEMatmul2, ctX, ctY, sk,
                 C: np.ndarray) -> float:
    """Max error against C of the two-sided opening of the raw tensor,
    decoded at Delta^2: the pass criterion's reference."""
    br, bi = ctx.decode(hm.decrypt_tensor_fn(hm.matmul_tensor(ctX, ctY), sk),
                        delta_override=float(ctx.params.delta) ** 2)
    return _max_err(br, bi, C)


def run(preset: str = "mid", device="cuda", auto_p: bool = False) -> dict:
    p = get_params(preset)
    print(f"[gl2-gemm] preset={preset}: n={p.n} (m={2 * p.n}), phi={p.phi}, "
          f"L={len(p.moduli)}")
    t0 = time.perf_counter()
    ctx = Gl2Context(p, device=device)
    dev = ctx.device
    hm = HEMatmul2(ctx)
    gr = Gl2GemmRelin(hm, RelinContext(ctx, p_moduli="auto")) if auto_p \
        else Gl2GemmRelin(hm)

    def gen(seed):
        return torch.Generator(device=dev).manual_seed(seed)

    sk = ctx.generate_secret_key(gen(1))
    ks = gr.gen_keys(sk, gen(9))
    init_s = clock(dev) - t0
    print(f"[gl2-gemm] init + switch-key gen {init_s:.1f}s "
          f"(dnum={gr.rc.dnum})")
    X, Y = complex_pair(p)
    C = np.conj(np.swapaxes(Y, -1, -2)) @ X
    t0 = clock(dev)
    ctX = ctx.encrypt(ctx.encode(torch.from_numpy(X.real).to(dev),
                                 torch.from_numpy(X.imag).to(dev)), sk, gen(2))
    ctY = ctx.encrypt(ctx.encode(torch.from_numpy(Y.real).to(dev),
                                 torch.from_numpy(Y.imag).to(dev)), sk, gen(4))
    enc_s = clock(dev) - t0
    print(f"[gl2-gemm] encode+encrypt {enc_s:.1f}s")
    own = Launches()
    t0 = clock(dev)
    with own:
        ct_out = gr.matmul(ctX, ctY, ks)
    first_s = clock(dev) - t0
    print(f"[gl2-gemm] gemm+relin first {first_s:.1f}s")
    t0 = clock(dev)
    with own:
        for _ in range(ITERS):
            ct_out = gr.matmul(ctX, ctY, ks)
    steady_ms = 1e3 * (clock(dev) - t0) / ITERS
    print(f"[gl2-gemm] gemm+relin steady {steady_ms:.1f} ms ({p.phi} lanes of "
          f"{p.n}x{p.n} complex GEMM)")
    t0 = clock(dev)
    with own:
        dr, di = ctx.decrypt_and_decode(ct_out, sk,
                                        delta_override=float(p.delta) ** 2)
    err = _max_err(dr, di, C)
    base_err = baseline_err(ctx, hm, ctX, ctY, sk, C)
    dec_s = clock(dev) - t0
    return {"preset": preset, "device": str(dev), "auto_p": auto_p,
            "dnum": gr.rc.dnum, "init_s": init_s, "encrypt_s": enc_s,
            "first_s": first_s, "steady_ms": steady_ms, "decode_s": dec_s,
            "err": err, "rel": err / float(np.abs(C).max()),
            "base_err": base_err, "limit": 2 * base_err + 0.1,
            "ok": bool(err < 2 * base_err + 0.1), "launches": own.counts()}


def main(argv=None) -> int:
    ap = parser(__doc__.splitlines()[0], "mid")
    ap.add_argument("--auto-p", action="store_true",
                    help="the generated P basis (RelinContext p_moduli='auto')")
    args = ap.parse_args(argv)
    res = run(args.preset, args.device, args.auto_p)
    print(f"[gl2-gemm] decrypt+decode and the two-sided baseline "
            f"{res['decode_s']:.1f}s")
    print(f"[gl2-gemm] max err {res['err']:.3e} (rel {res['rel']:.3e}) vs "
            f"Y^H X; two-sided baseline {res['base_err']:.3e}")
    print_launches(res["launches"])
    print(f"[gl2-gemm] {'OK' if res['ok'] else 'FAIL'}")
    return 0 if res["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
