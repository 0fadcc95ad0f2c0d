"""The client roundtrip: each request moves one pair of float64 [W, n, n]
messages, uniform(-range, range) from a pool of `pool` on the host,
through torch.from_numpy(...).to(device) -> encode_to_wntt_eval ->
encrypt_pair (fresh randomness) -> decrypt_pair_to_eval ->
decode_from_wntt_eval -> .cpu(), on the negacyclic ring.

The check reads, on each sampled request, with the reference's own
decryption b + a s of the request's ciphertexts under the benchmark's
secret (x: the centered W-coefficients of limb 0, which hold the Delta-
scaled plaintext whole):
  rt_err   max |out - m|, the configuration's precision contract;
  enc_gap  max |x - round(encode(m))|, the encode and the fresh noise,
           with the reference's complex128 encode;
  dec_gap  max |out - decode(x)|, the decode against the reference's
           complex128 decode of what the ciphertext holds.
"""

from __future__ import annotations

import numpy as np
import torch

from . import Check, generator, mark, params, secret_key, ternary


def setup(cfg, traffic, seed, device):
    from matrix_fhe_tpu_torch import HEContext
    mark("import")
    p = params(cfg)
    ctx = HEContext(p, ring="nega", device=device)
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
    return {"ctx": ctx, "sk": sk, "gen": gen, "s": s,
            "pool": pool, "device": torch.device(device)}


def request(st, i, spans):
    ctx, dev = st["ctx"], st["device"]
    be = ctx.batched_encoder
    k = i % len(st["pool"])
    m_re, m_im = st["pool"][k]
    with spans.span("upload"):
        mr = torch.from_numpy(m_re).to(dev)
        mi = torch.from_numpy(m_im).to(dev)
    with spans.span("encode"):
        pr, pi = be.encode_to_wntt_eval(mr, mi)
    with spans.span("encrypt"):
        ct_re, ct_im = ctx.encrypt_pair(pr, pi, st["sk"], generator=st["gen"])
    with spans.span("decrypt"):
        ev_re, ev_im = ctx.decrypt_pair_to_eval(ct_re, ct_im, st["sk"])
    with spans.span("decode"):
        out_re, out_im = be.decode_from_wntt_eval(ev_re, ev_im)
    with spans.span("download"):
        out = (out_re.cpu(), out_im.cpu())
    return k, (ct_re, ct_im), out


def release(st):
    for key in ("ctx", "sk", "gen"):
        st.pop(key, None)


def plaintext(ring, ct, s_hat) -> torch.Tensor:
    """The centered limb-0 W-coefficients of b + a s, [W, n, n] int64."""
    return ring.centered_wcoeff(ring.decrypt(ct.b, ct.a, s_hat))[0]


def check(st, samples, cfg, traffic):
    from ..reference.scheme import Codec, Ring, max_abs
    dev = st["s"].device
    ring = Ring(cfg["moduli"], cfg["n"], cfg["p"], "nega", dev)
    codec = Codec(cfg["n"], cfg["p"], 2.0 ** cfg["delta_bits"], dev)
    s_hat = ring.secret_hat(st["s"])
    rt = enc = dec = 0.0
    for k, (ct_re, ct_im), (out_re, out_im) in samples:
        m_re, m_im = (torch.from_numpy(x).to(dev) for x in st["pool"][k])
        out_re, out_im = out_re.to(dev), out_im.to(dev)
        x_re, x_im = (plaintext(ring, c, s_hat).to(torch.float64)
                      for c in (ct_re, ct_im))
        c_re, c_im = codec.encode(m_re, m_im)
        d_re, d_im = codec.decode(x_re, x_im)
        rt = max(rt, max_abs(out_re - m_re), max_abs(out_im - m_im))
        enc = max(enc, max_abs(x_re - torch.round(c_re)),
                  max_abs(x_im - torch.round(c_im)))
        dec = max(dec, max_abs(out_re - d_re), max_abs(out_im - d_im))
    lim = traffic["limits"]
    return [Check("rt_err", rt, cfg["precision"]["roundtrip_max_abs_err"]),
            Check("enc_gap", enc, lim["enc_gap"]),
            Check("dec_gap", dec, lim["dec_gap"])]
