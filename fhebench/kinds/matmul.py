"""The homomorphic trace GEMM C = Y^H X on the GL ring: each request
uploads two complex [W, n, n] messages of a pool of `pool` on the host
(real and imaginary parts uniform(-range, range)), X = entry i and
Y = entry i + 3 (mod pool), encodes and encrypts both with fresh
randomness, runs HEMatmul.matmul and HEMatmul.decrypt_and_decode (the
Delta^2 decode) and copies C to the host.

The check reads, on each sampled request:
  gemm_err  max |C - Y^H X| against the messages, the configuration's
            precision contract;
  gemm_gap  max |C - Yd^H Xd|, where Xd and Yd are the reference's
            complex128 decode of what the request's ciphertexts of X and
            Y hold (its own decryption b + a s in the GL ring under the
            benchmark's secret): the product the GEMM and the Delta^2
            decode owe, noise and all, so only their own error remains.
"""

from __future__ import annotations

import numpy as np
import torch

from . import Check, generator, mark, params, secret_key, ternary
from .roundtrip import plaintext


def setup(cfg, traffic, seed, device):
    from matrix_fhe_tpu_torch import HEContext, HEMatmul
    mark("import")
    p = params(cfg)
    ctx = HEContext(p, ring="gl", device=device)
    hm = HEMatmul(ctx)
    mark("context")
    gen = generator(seed, device)
    s = ternary(gen, p.phi, p.n, device)
    sk = secret_key(ctx, s)
    mark("keys")
    rng = np.random.default_rng(seed & ((1 << 63) - 1))
    r = traffic["message_range"]
    shape = (p.phi, p.n, p.n)
    pool = [(rng.uniform(-r, r, shape), rng.uniform(-r, r, shape))
            for _ in range(traffic["pool"])]
    mark("pool")
    return {"ctx": ctx, "hm": hm, "sk": sk,
            "gen": gen, "s": s, "pool": pool, "device": torch.device(device)}


def operands(i: int, pool: int):
    return i % pool, (i + 3) % pool


def request(st, i, spans):
    ctx, dev, hm = st["ctx"], st["device"], st["hm"]
    be = ctx.batched_encoder
    kx, ky = operands(i, len(st["pool"]))
    with spans.span("upload"):
        msgs = [torch.from_numpy(v).to(dev)
                for k in (kx, ky) for v in st["pool"][k]]
    with spans.span("encode"):
        px = be.encode_to_wntt_eval(msgs[0], msgs[1])
        py = be.encode_to_wntt_eval(msgs[2], msgs[3])
    with spans.span("encrypt"):
        ct_x = ctx.encrypt_pair(*px, st["sk"], generator=st["gen"])
        ct_y = ctx.encrypt_pair(*py, st["sk"], generator=st["gen"])
    del px, py, msgs
    with spans.span("gemm"):
        tt = hm.matmul(ct_x, ct_y)
    with spans.span("decode_d2"):
        c_re, c_im = hm.decrypt_and_decode(tt, st["sk"])
    del tt
    with spans.span("download"):
        out = (c_re.cpu(), c_im.cpu())
    return kx, ky, ct_x, ct_y, out


def release(st):
    for key in ("ctx", "hm", "sk", "gen"):
        st.pop(key, None)


def check(st, samples, cfg, traffic):
    from ..reference.scheme import Codec, Ring, max_abs
    dev = st["s"].device
    ring = Ring(cfg["moduli"], cfg["n"], cfg["p"], "gl", dev)
    codec = Codec(cfg["n"], cfg["p"], 2.0 ** cfg["delta_bits"], dev)
    s_hat = ring.secret_hat(st["s"])

    def held(ct):
        x_re, x_im = (plaintext(ring, c, s_hat).to(torch.float64) for c in ct)
        return torch.complex(*codec.decode(x_re, x_im))

    def product(x, y):
        return y.conj().transpose(-1, -2) @ x

    err = gap = 0.0
    for kx, ky, ct_x, ct_y, (c_re, c_im) in samples:
        c = torch.complex(c_re, c_im).to(dev)
        x, y = (torch.complex(*(torch.from_numpy(v) for v in st["pool"][k])
                              ).to(dev) for k in (kx, ky))
        err = max(err, max_abs(c - product(x, y)))
        gap = max(gap, max_abs(c - product(held(ct_x), held(ct_y))))
    return [Check("gemm_err", err, cfg["precision"]["matmul_max_abs_err"]),
            Check("gemm_gap", gap, traffic["limits"]["gemm_gap"])]
