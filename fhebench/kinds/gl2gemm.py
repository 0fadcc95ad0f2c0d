"""The ciphertext-out trace GEMM on the gl2 double ring: each request is
Gl2GemmRelin.matmul(X, Y, keys), C = Y^H X per lane as a standard gl2
ciphertext that stays on the card (HEMatmul2's tensor, kernel K7, then
the relinearize of its ss(x)1 and ss(x)s components with the GEMM's two
switch keys a digit, and the repack rho).

Set-up keys the GEMM from the benchmark's ternary secret [W, 2n] and
encrypts a pool of `pool` ciphertexts of complex [W, n, n] messages
(real and imaginary parts uniform(-range, range), kept on the host),
each with fresh randomness.  Request i takes X = entry i and Y = entry
i + 3 (mod pool).

The check decrypts the sampled outputs and their inputs with the
benchmark's secret in the reference's own arithmetic
(fhebench/reference/gl2.py) and reads
  gl2_noise  the largest |centered W-coefficient|, composed exactly over
             every limb, of dec(C) minus the plaintext the GEMM owes the
             decrypted inputs: the key switch's noise alone; a wrong
             tensor, key product or ModDown leaves a random residue in
             some limb, which composes to about half of Q; limit the
             configuration's relin_noise;
  gl2_err    max |decode_Delta^2(dec(C)) - Y^H X| against the messages,
             the configuration's precision contract;
  gl2_gap    the same against Yd^H Xd, Xd and Yd the reference's decodes
             of what the input ciphertexts hold: the GEMM's own error.
"""

from __future__ import annotations

import numpy as np
import torch

from . import Check, MASK63, generator, mark, params, residues, ternary
from .matmul import operands


def secret_key2(ctx, s: torch.Tensor):
    """The program's SecretKey2 of the benchmark's secret s [W, 2n]: the
    W-CRT and 2n-point X-NTT of s in the storage form s 2^64 mod q, and
    its sign pattern, as Gl2Context.generate_secret_key makes them from
    its own draw."""
    from matrix_fhe_tpu_torch.models.he2 import SecretKey2
    from matrix_fhe_tpu_torch.ops import modmath as mm
    moduli = ctx.params.moduli
    s_ntt = ctx.xntt.forward(ctx.wt.forward(residues(s, moduli)))
    return SecretKey2(mm.to_mont(s_ntt, moduli), s.to(torch.int8))


def setup(cfg, traffic, seed, device):
    from matrix_fhe_tpu_torch import (Gl2Context, Gl2GemmRelin, HEMatmul2,
                                      RelinContext)
    mark("import")
    p = params(cfg)
    ctx = Gl2Context(p, device=device)
    hm = HEMatmul2(ctx)
    mark("context")
    gr = Gl2GemmRelin(hm, RelinContext(ctx, p_moduli=cfg["p_moduli"]))
    mark("relin_context")
    gen = generator(seed, device)
    s = ternary(gen, p.phi, 2 * p.n, device)
    sk = secret_key2(ctx, s)
    keys = gr.gen_keys(sk, gen)
    mark("keys")
    rng = np.random.default_rng(seed & MASK63)
    r = traffic["message_range"]
    shape = (p.phi, p.n, p.n)
    msgs = [(rng.uniform(-r, r, shape), rng.uniform(-r, r, shape))
            for _ in range(traffic["pool"])]
    dev = torch.device(device)
    pool = [ctx.encrypt(ctx.encode(*(torch.from_numpy(v).to(dev) for v in m)),
                        sk, gen) for m in msgs]
    mark("pool")
    return {"ctx": ctx, "gr": gr, "keys": keys, "s": s, "msgs": msgs,
            "pool": pool}


def request(st, i, spans):
    pool = st["pool"]
    kx, ky = operands(i, len(pool))
    with spans.span("gl2gemm"):
        out = st["gr"].matmul(pool[kx], pool[ky], st["keys"])
    return kx, ky, out


def release(st):
    for key in ("ctx", "gr", "keys"):
        st.pop(key, None)


def check(st, samples, cfg, traffic):
    from ..reference.gl2 import Gl2Ring
    from ..reference.scheme import Codec, max_abs
    dev = st["s"].device
    ring = Gl2Ring(cfg["moduli"], cfg["n"], cfg["p"], dev)
    delta = 2.0 ** cfg["delta_bits"]
    codec = Codec(cfg["n"], cfg["p"], delta, dev)
    codec2 = Codec(cfg["n"], cfg["p"], delta * delta, dev)
    s_mat = ring.secret(st["s"])
    pool, msgs = st["pool"], st["msgs"]

    def product(x, y):
        return y.conj().transpose(-1, -2) @ x

    noise = err = gap = 0.0
    for kx, ky, out in samples:
        m_x, m_y = (ring.decrypt(pool[k].b, pool[k].a, s_mat)
                    for k in (kx, ky))
        got = ring.decrypt(out.b, out.a, s_mat)
        diff = (got - ring.owed(m_x, m_y)) % ring.q(got.dim())
        noise = max(noise, max_abs(ring.composed(diff)))
        del diff
        c = ring.decode(got, codec2)
        x, y = (torch.complex(*(torch.from_numpy(v) for v in msgs[k])
                              ).to(dev) for k in (kx, ky))
        err = max(err, max_abs(c - product(x, y)))
        gap = max(gap, max_abs(c - product(ring.decode(m_x, codec),
                                           ring.decode(m_y, codec))))
    return [Check("gl2_noise", noise, cfg["precision"]["relin_noise"]),
            Check("gl2_err", err, cfg["precision"]["matmul_max_abs_err"]),
            Check("gl2_gap", gap, traffic["limits"]["gl2_gap"])]
