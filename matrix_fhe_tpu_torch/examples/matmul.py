"""Homomorphic matrix multiplication in the GL ring.

    python -m matrix_fhe_tpu_torch.examples.matmul [preset] [--device cpu]

Counterpart of examples/matmul.py: two batches of phi packed n x n
complex matrices from default_rng(7) (A, then B, real parts first), a
fresh secret key and encryptions (generators seeded 3, 11 and 12, where
the JAX script takes jax.random.key(3), key(11), key(12)), the trace-GEMM
tensor (HEMatmul.matmul: K6, K2, K1), the two-sided decrypt and Delta^2
decode (K2, K1, K4), and max |C - Y^H X| < 1e-4 at ref, 0.5 otherwise.
Default preset: ref.
"""

from __future__ import annotations

import sys
import time
from typing import Tuple

import numpy as np
import torch

from ..config import get_params
from ..models.he import Ciphertext, HEContext, SecretKey
from ..models.he_matmul import HEMatmul
from ..ops._backend import Launches
from ..ops.ntt import RING_GL
from ..utils.timing import clock
from . import complex_pair, parser, print_launches


def encrypt(ctx: HEContext, M: np.ndarray, sk: SecretKey,
            generator: torch.Generator) -> Tuple[Ciphertext, Ciphertext]:
    """encode_to_wntt_eval, then encrypt_pair with fresh `a` and noise."""
    dev = ctx.device
    pr, pi = ctx.batched_encoder.encode_to_wntt_eval(
        torch.from_numpy(M.real).to(dev), torch.from_numpy(M.imag).to(dev))
    return ctx.encrypt_pair(pr, pi, sk, generator=generator)


def product(hm: HEMatmul, ctA, ctB, sk: SecretKey,
            times: dict | None = None) -> np.ndarray:
    """The homomorphic C = Y^H X of the ciphertexts of A (X) and B (Y),
    decrypted and decoded; `times` gets the tensor's and the decode's
    seconds."""
    dev = hm.ctx.device
    t0 = clock(dev)
    tt = hm.matmul(ctA, ctB)
    t1 = clock(dev)
    dr, di = hm.decrypt_and_decode(tt, sk)
    t2 = clock(dev)
    if times is not None:
        times.update(gemm_s=t1 - t0, decode_s=t2 - t1)
    return dr.cpu().numpy() + 1j * di.cpu().numpy()


def run(preset: str = "ref", device="cuda") -> dict:
    p = get_params(preset)
    print(f"[matmul] preset={preset}: n={p.n}, phi={p.phi}, L={len(p.moduli)}")
    t0 = time.perf_counter()
    ctx = HEContext(p, ring=RING_GL, device=device)
    dev = ctx.device
    hm = HEMatmul(ctx)

    def gen(seed):
        return torch.Generator(device=dev).manual_seed(seed)

    sk = ctx.generate_secret_key(gen(3))
    init_s = clock(dev) - t0
    print(f"[matmul] init {init_s:.1f}s")
    A, B = complex_pair(p)
    t0 = clock(dev)
    ctA, ctB = encrypt(ctx, A, sk, gen(11)), encrypt(ctx, B, sk, gen(12))
    enc_s = clock(dev) - t0
    print(f"[matmul] encode+encrypt {enc_s:.1f}s")
    times: dict = {}
    own = Launches()
    with own:
        C = product(hm, ctA, ctB, sk, times)
    ref = np.conj(np.swapaxes(B, 1, 2)) @ A
    err = float(np.abs(C - ref).max())
    tol = 1e-4 if preset == "ref" else 0.5
    return {"preset": preset, "device": str(dev), "init_s": init_s,
            "encrypt_s": enc_s, "gemm_ms": 1e3 * times["gemm_s"],
            "decode_ms": 1e3 * times["decode_s"], "err": err,
            "ref_magnitude": float(np.abs(ref).max()), "tol": tol,
            "ok": bool(np.isfinite(C).all() and err < tol),
            "launches": own.counts()}


def main(argv=None) -> int:
    args = parser(__doc__.splitlines()[0], "ref").parse_args(argv)
    res = run(args.preset, args.device)
    print(f"[matmul] homomorphic GEMM {res['gemm_ms']:.1f} ms (first call), "
            f"decrypt+decode {res['decode_ms']:.1f} ms")
    print(f"[matmul] max |C - Y^H X| = {res['err']:.3e}  "
            f"(ref magnitude {res['ref_magnitude']:.2f})")
    print_launches(res["launches"])
    print("[matmul] PASS" if res["ok"] else "[matmul] FAIL")
    return 0 if res["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
