"""Relinearized multiply: each request is
RelinContext.multiply_relinearize(ct1, ct2, rlk) on two ciphertexts of the
pool, in the stored (W-eval, X-coeff) layout on the negacyclic ring.

The pool holds `pool` ciphertexts, encrypted in pairs by encrypt_pair with
fresh randomness, of integer messages below 2^message_bits in every limb
(examples/relinearize.py's messages).  Request i multiplies entries 2i and
2i + 3 (mod pool), so no request reuses the last one's inputs and no
product is of the two halves of one pair.

The check decrypts the sampled products and their factors with the
benchmark's secret, b + a s in the reference's own arithmetic, and reads
relin_noise: the largest |centered| W-coefficient, over every limb, of
dec(ct) - dec(ct1) dec(ct2).  That difference is the key switch's noise, a
small integer alike in every limb; a wrong tensor product, digit step or
ModDown makes it a random residue.
"""

from __future__ import annotations

from . import (Check, generator, mark, params, residues, secret_key,
               ternary)


def setup(cfg, traffic, seed, device):
    from matrix_fhe_tpu_torch import HEContext, RelinContext
    import torch
    mark("import")
    p = params(cfg)
    ctx = HEContext(p, ring="nega", device=device)
    mark("context")
    rc = RelinContext(ctx, p_moduli=cfg["p_moduli"])
    mark("relin_context")
    gen = generator(seed, device)
    s = ternary(gen, p.phi, p.n, device)
    sk = secret_key(ctx, s)
    rlk = rc.gen_relin_key(residues(s, p.moduli), gen)
    mark("keys")
    shape = (len(p.moduli), p.phi, p.n, p.n)
    pool = []
    for _ in range(traffic["pool"] // 2):
        m1, m2 = (torch.randint(0, 1 << traffic["message_bits"], shape,
                                generator=gen, dtype=torch.int64,
                                device=device) for _ in range(2))
        pool.extend(ctx.encrypt_pair(m1, m2, sk, generator=gen))
        del m1, m2
    mark("pool")
    return {"ctx": ctx, "rc": rc, "rlk": rlk, "s": s, "pool": pool,
            "dnum": rc.dnum}


def pair(i: int, pool: int):
    return (2 * i) % pool, (2 * i + 3) % pool


def request(st, i, spans):
    a, b = pair(i, len(st["pool"]))
    with spans.span("relin"):
        ct = st["rc"].multiply_relinearize(st["pool"][a], st["pool"][b],
                                           st["rlk"])
    return a, b, ct


def release(st):
    for k in ("ctx", "rc", "rlk"):
        st.pop(k, None)


def check(st, samples, cfg, traffic):
    from ..reference.scheme import Ring, max_abs
    ring = Ring(cfg["moduli"], cfg["n"], cfg["p"], "nega", st["s"].device)
    s_hat = ring.secret_hat(st["s"])
    pool = st["pool"]
    worst = 0.0
    for a, b, ct in samples:
        d1 = ring.decrypt(pool[a].b, pool[a].a, s_hat)
        d2 = ring.decrypt(pool[b].b, pool[b].a, s_hat)
        want = ring.x_product(d1, ring.x_hat(d2))
        del d1, d2
        got = ring.decrypt(ct.b, ct.a, s_hat)
        q = ring.q(got.dim())
        worst = max(worst, max_abs(ring.centered_wcoeff((got - want) % q)))
    return [Check("relin_noise", worst, cfg["precision"]["relin_noise"])]
