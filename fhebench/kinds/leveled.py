"""Leveled chain: each request is examples/leveled.py's depth-2 circuit on
the program's LeveledChain,

    z = x y (relinearized, level 0)  ->  rescale(z) (level 1)
      ->  w = z mod_switch(x, 1) (relinearized, level 1)
      ->  rotate(w, j, full=True),

with j drawn for each request, uniform over the units mod p (one draw a
request from a generator seeded by the run): the rotation takes
t + popcount(e) switches with the level's full Galois key set, where
j = T^t G^e.  Warm-up requests rotate by the unit that takes every key.

The chain is keyed from the benchmark's secret.  The pool holds `pool`
ciphertexts at level 0, encrypted in pairs by encrypt_pair with fresh
randomness, of integer W-coefficients below 2^message_bits alike in every
limb (examples/leveled.py's messages: the rescale needs limb-consistent
integers).  Request i takes entries 2i and 2i + 3 (mod pool), as the relin
kind.

The check decrypts the sampled results w, their rescaled intermediates zr
and their inputs with the benchmark's secret, and composes every
difference exactly across the level's limbs
(fhebench/reference/leveled.py), reading the largest |centered|
W-coefficient of

  leveled_noise       dec(w) - tau_j(rescale(m_x m_y) m_x), from the
                      decrypted inputs m_x, m_y alone: the rescale's
                      rounding (from a and s) times the message m_x,
                      summed over the ring, about 2^31 at ref; limit 2^40,
                      examples/leveled.py's oracle limit;
  leveled_step_noise  the larger of dec(zr) - rescale(m_x m_y) and
                      dec(w) - tau_j(dec(zr) m_x): the rounding, and the
                      level-1 multiply's and the rotation's key-switch
                      noise (as examples/leveled.py's oracle), about 2^10
                      at ref; limit the configuration's relin_noise.

The second reading is the one that sees a wrong rotation: the messages
sit at scale 1, so w itself is about 2^40 at ref, and a rotation by
another unit, or one hop left out, moves dec(w) by about that much,
which leveled_noise's limit admits.  A wrong key switch or rescale, or a
lower-precision base conversion, leaves a random residue in some limb,
which composes to about half the level's modulus in both readings.
"""

from __future__ import annotations

import random

from . import Check, generator, mark, params, residues, ternary
from .relin import pair


def setup(cfg, traffic, seed, device):
    import torch
    from matrix_fhe_tpu_torch import LeveledChain
    from matrix_fhe_tpu_torch.models.leveled import LeveledCt

    from ..reference.leveled import units
    mark("import")
    p = params(cfg)
    gen = generator(seed, device)
    s = ternary(gen, p.phi, p.n, device)
    chain = LeveledChain(p, seed=seed, p_moduli=cfg["p_moduli"],
                         device=device, secret=s)
    for level in (0, 1):
        chain.rc(level)
    mark("contexts")
    chain.rlk(0)
    chain.rlk(1)
    full = chain.full_galois(1)
    mark("keys")
    c0, sk = chain.ctx(0), chain.sk(0)
    shape = (p.phi, p.n, p.n)
    pool = []
    for _ in range(traffic["pool"] // 2):
        m1, m2 = (c0.wt.forward(residues(torch.randint(
            0, 1 << traffic["message_bits"], shape, generator=gen,
            dtype=torch.int64, device=device), p.moduli)) for _ in range(2))
        pool.extend(LeveledCt(ct, 0, p.delta)
                    for ct in c0.encrypt_pair(m1, m2, sk, generator=gen))
        del m1, m2
    mark("pool")
    js = units(p.p)

    def hops(j):
        t, e = full.decompose(j)
        return t + bin(e).count("1")

    return {"chain": chain, "s": s, "pool": pool, "units": js,
            "warm_j": max(js, key=hops), "draw": random.Random(seed)}


def request(st, i, spans):
    chain, pool = st["chain"], st["pool"]
    a, b = pair(i, len(pool))
    js = st["units"]
    j = st["warm_j"] if i < 0 else js[st["draw"].randrange(len(js))]
    with spans.span("leveled"):
        x = pool[a]
        zr = chain.rescale(chain.multiply(x, pool[b]))
        w = chain.rotate(chain.multiply(zr, chain.mod_switch(x, 1)), j,
                         full=True)
    return a, b, j, zr.ct, w.ct


def release(st):
    st.pop("chain", None)


def check(st, samples, cfg, traffic):
    from ..reference import leveled as ref
    from ..reference.scheme import Ring
    ring = Ring(cfg["moduli"], cfg["n"], cfg["p"], "nega", st["s"].device)
    ring1 = ref.prefix(ring, len(ring.moduli) - 1)
    s_hat = ring.secret_hat(st["s"])
    pool = st["pool"]
    worst = step = 0.0
    for a, b, j, zr, w in samples:
        m_x, m_y = (ring.decrypt(pool[k].ct.b, pool[k].ct.a, s_hat)
                    for k in (a, b))
        want_zr = ref.rescaled(ring, m_x, m_y)
        del m_y
        got_zr = ring1.decrypt(zr.b, zr.a, s_hat[:-1])
        got = ring1.decrypt(w.b, w.a, s_hat[:-1])
        m_x1 = m_x[:-1]
        del m_x
        worst = max(worst, ref.noise(ring1, got, ref.rotated_product(
            ring1, want_zr, m_x1, j)))
        step = max(step, ref.noise(ring1, got_zr, want_zr),
                   ref.noise(ring1, got, ref.rotated_product(
                       ring1, got_zr, m_x1, j)))
    return [Check("leveled_noise", worst, traffic["limits"]["leveled_noise"]),
            Check("leveled_step_noise", step,
                  cfg["precision"]["relin_noise"])]
