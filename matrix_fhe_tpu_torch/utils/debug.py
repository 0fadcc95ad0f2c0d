"""Debug and sanity hooks mirroring the reference's device checks.

Counterpart of matrix_fhe_tpu/utils/debug.py:

  * check_moduli: the moduli readback (copy_device_moduli, HE.cu:410-422):
    the device-resident per-limb constants of a context's kernels agree
    with the host parameter set bit for bit;
  * count_nonzero / count_over_i64: the sanity kernels
    count_nonzero_i64_kernel / count_big_over_i64_kernel (HE.cu:1204-1222)
    as tensor reductions;
  * composed_magnitude / noise_magnitude: the exact noise meter, on the
    port's exact CRTComposer (ops/crt.py) on the context's device.  The
    JAX package composes host Python integers, which at ref would be 2.1 M
    elements x 11 limbs of big-int work; here the compose runs on 32-bit
    digit tensors and only the maximum comes back to the host.
  * ring_mul / relin_noise: the plaintext ring product (the JAX
    examples' mont_mul oracle: X-NTT both, multiply, inverse X-NTT) and
    the relinearization noise of examples/relinearize.py, measured at
    limb 0 in the W-coefficient domain.
"""

from __future__ import annotations

from typing import List

import torch

from ..ops import modmath as mm


def check_moduli(ctx) -> bool:
    """Read the device copies of the moduli and Montgomery constants back
    and compare them with the host parameter set (the reference prints and
    aborts; here: False on a mismatch)."""
    want = [int(q) for q in ctx.params.moduli]
    if ctx._q4.reshape(-1).tolist() != want:
        return False
    for stage in (ctx.wt._fwd, ctx.wt._inv, ctx.xntt._fwd, ctx.xntt._inv):
        consts = stage.consts.cpu().tolist()        # [q, -q^-1, 2^128 mod q]
        for q, row in zip(want, consts):
            c = mm.MontConsts.make(q)
            if [v % (1 << 64) for v in row] != [c.q, c.qinv_neg, c.r2]:
                return False
    return True


def count_nonzero(x: torch.Tensor) -> int:
    """count_nonzero_i64_kernel (HE.cu:1204-1211)."""
    return int((x != 0).sum())


def count_over_i64(mag_hi_words: torch.Tensor) -> int:
    """count_big_over_i64_kernel (HE.cu:1213-1222): how many big-int
    magnitudes exceed int64 (any high word nonzero, words on the last
    axis)."""
    return int((mag_hi_words != 0).any(dim=-1).sum())


def _max_digits(digits: List[torch.Tensor]) -> int:
    """Largest value over the elements of a big integer given as 32-bit
    digit tensors (least significant first), compared digit by digit from
    the top on the device."""
    best = 0
    alive = torch.ones_like(digits[0], dtype=torch.bool)
    for d in reversed(digits):
        top = int(torch.where(alive, d, -1).max())
        alive &= d == top
        best = (best << 32) | top
    return best


def composed_magnitude(ctx, x_eval: torch.Tensor) -> int:
    """Max |centered CRT-composed integer| of a mod-Q element in the stored
    (W-eval, X-coeff) layout: the way to measure key-switch and rescale
    noise, since a small ring element has full-range W-eval lane values and
    its smallness lives in its W coefficients.  Exact."""
    mag, _ = ctx.wt.composer.compose_magnitude(ctx.wt.inverse(x_eval))
    return _max_digits(mag)


def noise_magnitude(ctx, ct, sk, expected_eval: torch.Tensor) -> int:
    """Debug only (needs the secret key): max |composed noise integer| of
    `ct` against the expected plaintext (stored layout)."""
    got = ctx.decrypt_to_eval(ct, sk)
    return composed_magnitude(ctx, mm.sub_mod(got, expected_eval, ctx._q4))


def ring_mul(ctx, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The exact ring product of two plaintexts in the stored layout
    (W-eval, X-coeff): iNTT_X(NTT_X(a) * NTT_X(b)), each product an X-NTT
    fused with the other factor's transform in storage form (K10a)."""
    xn = ctx.xntt
    return xn.inverse(xn.forward_mul(b, xn.forward_mul(a, ctx._r2_tw)))


def relin_noise(ctx, ct, ct1, ct2, sk) -> int:
    """max |centered| limb-0 W-coefficient of dec(ct) - dec(ct1) dec(ct2)
    (examples/relinearize.py's check)."""
    diff = mm.sub_mod(ctx.decrypt_to_eval(ct, sk),
                      ring_mul(ctx, ctx.decrypt_to_eval(ct1, sk),
                               ctx.decrypt_to_eval(ct2, sk)), ctx._q4)
    dw0 = ctx.wt.inverse(diff)[0]
    q0 = int(ctx.params.moduli[0])
    return int(torch.where(dw0 > q0 // 2, dw0 - q0, dw0).abs().max())
