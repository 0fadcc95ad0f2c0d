"""Two chained encrypted GEMMs on the gl2 double ring: each request is

    B = matmul(A, Q) = Q^H A   (level 0, scale Delta^2)
    B' = rescale(B)            (level 1, scale Delta^2 / q_last)
    G = matmul(B', B') = B'^H B'   (level 1, with the level's own keys)

on the program's Gl2Chain, A = entry i and Q = entry i + 3 (mod pool) of
a pool of `pool` ciphertexts of complex [W, n, n] messages (real and
imaginary parts uniform(-range, range), kept on the host), each
encrypted at level 0 with fresh randomness.  G stays encrypted on the
card.  The chain is keyed from the benchmark's ternary secret [W, 2n],
with GEMM switch keys at the configuration's `gemm_key_levels`.

The check decrypts the sampled requests' inputs, B, B' and G with the
benchmark's secret in the reference's own arithmetic
(fhebench/reference/gl2_chain.py) and reads, against the limits of the
configuration (`precision`) and the traffic (`limits`):
  chain_noise0   step 0's key-switch noise: dec(B) less the GEMM owed its
                 decrypted inputs, composed exactly over every limb;
                 limit relin_noise, 2^25;
  rescale_noise  dec(B') less round(dec(B) / q_last): the components'
                 rounding, a few hundred; limit rescale_noise, 2^25; a
                 missing division reads dec(B) itself (~3e19 at ref), a
                 wrong one near half of the level-1 modulus;
  chain_noise1   step 1's key-switch noise against dec(B'); limit
                 relin_noise;
  chain_gap      the decode of G at its scale against B'd^H B'd, B'd the
                 decode of dec(B'): the second GEMM's own error; limit
                 the traffic's 1e-6, as gl2_gap's;
  chain_err      max |G - G_true| / (2 n max |B_true| matmul_max_abs_err),
                 G_true = B_true^H B_true, B_true = Q^H A from the
                 messages in complex128: the first product's contract
                 carried to first order through the second; limit the
                 traffic's 0.009, between the sound runs and the
                 reference's decodes in complex64.
"""

from __future__ import annotations

import numpy as np
import torch

from . import MASK63, Check, generator, mark, params, ternary
from .matmul import operands


def setup(cfg, traffic, seed, device):
    from matrix_fhe_tpu_torch import Gl2Chain
    mark("import")
    p = params(cfg)
    gen = generator(seed, device)
    s = ternary(gen, p.phi, 2 * p.n, device)
    chain = Gl2Chain(p, seed=seed, p_moduli=cfg["p_moduli"], device=device,
                     secret=s)
    for level in cfg["gemm_key_levels"]:
        chain.gemm(level)
    mark("contexts")
    for level in cfg["gemm_key_levels"]:
        chain.gemm_keys(level)
    mark("keys")
    rng = np.random.default_rng(seed & MASK63)
    r = traffic["message_range"]
    shape = (p.phi, p.n, p.n)
    msgs = [(rng.uniform(-r, r, shape), rng.uniform(-r, r, shape))
            for _ in range(traffic["pool"])]
    dev = torch.device(device)
    pool = [chain.encrypt(*(torch.from_numpy(v).to(dev) for v in m), gen)
            for m in msgs]
    mark("pool")
    return {"chain": chain, "s": s, "msgs": msgs, "pool": pool}


def request(st, i, spans):
    chain, pool = st["chain"], st["pool"]
    ka, kq = operands(i, len(pool))
    with spans.span("gl2chain"):
        b = chain.matmul(pool[ka], pool[kq])
        b1 = chain.rescale(b)
        g = chain.matmul(b1, b1)
    return ka, kq, b.ct, b1.ct, g.ct


def release(st):
    st.pop("chain", None)


def check(st, samples, cfg, traffic):
    from ..reference.gl2_chain import Gl2ChainReference
    prec, lim = cfg["precision"], traffic["limits"]
    ref = Gl2ChainReference(cfg["moduli"], cfg["n"], cfg["p"],
                            2.0 ** cfg["delta_bits"], st["s"],
                            prec["matmul_max_abs_err"])
    dev = st["s"].device
    pool, msgs = st["pool"], st["msgs"]
    worst = dict.fromkeys(("chain_noise0", "rescale_noise", "chain_noise1",
                           "chain_gap", "chain_err"), 0.0)
    for ka, kq, b, b1, g in samples:
        m_a, m_q = (torch.complex(*(torch.from_numpy(v) for v in msgs[k])
                                  ).to(dev) for k in (ka, kq))
        got = ref.readings(pool[ka].ct, pool[kq].ct, b, b1, g, m_a, m_q)
        worst = {k: max(v, got[k]) for k, v in worst.items()}
    limits = {"chain_noise0": prec["relin_noise"],
              "rescale_noise": prec["rescale_noise"],
              "chain_noise1": prec["relin_noise"],
              "chain_gap": lim["chain_gap"], "chain_err": lim["chain_err"]}
    return [Check(k, v, limits[k]) for k, v in worst.items()]
