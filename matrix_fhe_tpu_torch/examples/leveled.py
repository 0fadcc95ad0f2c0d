"""Leveled homomorphic computation with automatic scale management.

    python -m matrix_fhe_tpu_torch.examples.leveled [preset] [--device cpu]

Counterpart of examples/leveled.py: on the LeveledChain (seed 0, where the
JAX script takes jax.random.key(0)) the depth-2 circuit

    z = x * y            (relinearized, scale Delta^2)
    z = rescale(z)       (level 1, scale Delta^2 / q_dropped)
    w = z * mod_switch(x, 1)
    w = rotate(w, j)     (the full Galois set at level 1)

on two messages of default_rng(3) integers below 2^16 (K10a's twiddle
form, K1, K2), held to the exact plaintext ring oracle on the same
contexts: the composed |ct - oracle| < 2^40.  The launches line counts
the circuit and its decrypt, not the oracle.  The JAX script's oracle
multiplies the X-NTTs by mont_mul after to_mont; utils.debug.ring_mul
computes the same product of canonical residues.  Default preset: mid.
"""

from __future__ import annotations

import sys
import time

import numpy as np
import torch

from ..config import get_params
from ..models.keyswitch import w_automorphism_perm
from ..models.leveled import LeveledChain
from ..ops import modmath as mm
from ..ops._backend import Launches
from ..utils.debug import composed_magnitude, ring_mul
from ..utils.timing import clock
from . import parser, print_launches


def oracle_distance(chain: LeveledChain, x, zr, got: torch.Tensor,
                    j: int) -> int:
    """Composed max |got - oracle|, the oracle being the rotation by j of
    dec(zr) * dec(x) mod_switched to level 1 (dec(zr) carries the rescale's
    rounding)."""
    c0, c1 = chain.ctx(0), chain.ctx(1)
    px = c0.decrypt_to_eval(x.ct, chain.sk(0))
    pz = c1.decrypt_to_eval(zr.ct, chain.sk(1))
    perm = torch.from_numpy(w_automorphism_perm(chain.params_at(1), j)).to(
        got.device)
    want = ring_mul(c1, pz, px[:-1])[:, perm]
    return composed_magnitude(c1, mm.sub_mod(got, want, c1._q4))


def run(preset: str = "mid", device="cuda") -> dict:
    p = get_params(preset)
    t0 = time.perf_counter()
    chain = LeveledChain(p, ring="nega", seed=0, device=device)
    dev = chain.device
    print(f"[leveled] preset={preset}: chain depth {chain.depth}, P basis "
          f"{[int(q).bit_length() for q in chain.rc(0).p_moduli]} "
          f"(dnum={chain.rc(0).dnum})")
    rng = np.random.default_rng(3)

    def msg():
        c = torch.from_numpy(rng.integers(0, 1 << 16, size=(p.phi, p.n, p.n)))
        return chain.ctx(0).wt.forward(torch.stack(
            [c % int(q) for q in p.moduli]).to(dev))

    x, y = chain.encrypt(msg()), chain.encrypt(msg())
    init_s = clock(dev) - t0
    print(f"[leveled] init+keys+encrypt {init_s:.1f}s")
    j = next(c for c in range(2, p.p) if np.gcd(c, p.p) == 1)
    own = Launches()
    t0 = clock(dev)
    with own:
        z = chain.multiply(x, y)
        zr = chain.rescale(z)
        w = chain.multiply(zr, chain.mod_switch(x, 1))
        w = chain.rotate(w, j, full=True)
        got = chain.decrypt_to_eval(w)
    circuit_s = clock(dev) - t0
    print(f"[leveled] depth-2 + rotate + decrypt {circuit_s:.1f}s (level "
          f"{w.level}, scale 2^{np.log2(w.scale):.1f})")
    mag = oracle_distance(chain, x, zr, got, j)
    return {"preset": preset, "device": str(dev), "j": j, "level": w.level,
            "scale_log2": float(np.log2(w.scale)), "init_s": init_s,
            "circuit_s": circuit_s, "oracle": mag, "limit": 1 << 40,
            "ok": bool(mag < 1 << 40), "launches": own.counts()}


def main(argv=None) -> int:
    args = parser(__doc__.splitlines()[0], "mid").parse_args(argv)
    res = run(args.preset, args.device)
    print_launches(res["launches"])
    print(f"[leveled] |ct - oracle| composed max = {res['oracle']} "
            f"({'OK' if res['ok'] else 'FAIL'})")
    return 0 if res["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
