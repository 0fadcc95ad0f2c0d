"""The rest of the port's encoder / W-CRT / X-NTT surface against the JAX
package: the reference's per-lane Encoder.encode and decode, the zero-key
isolation fixture, BatchedEncoder.unpack_eval, WTransform.inverse_scaled
and the centered HE.cu oracle (with its int64 saturation), XNTT.wrap_constant
and apply_gl_perm, and the two *_streamed names, which are the port's one
route (mirroring tests/test_encode_decode.py, test_wcrt.py, test_ntt.py,
test_keyswitch.py::test_streamed_matches_fused and
test_he_matmul2.py::test_relinearize_streamed_matches_fused).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_workers  # noqa: F401
from matrix_fhe_tpu.config import get_params as jax_params
from matrix_fhe_tpu.models.encoder import Encoder as JaxEncoder
from matrix_fhe_tpu.ops import ntt as jntt
from matrix_fhe_tpu.ops.wcrt import WTransform as JaxW
from matrix_fhe_tpu_torch import convert
from matrix_fhe_tpu_torch.config import get_params
from matrix_fhe_tpu_torch.models.batched_encoder import BatchedEncoder
from matrix_fhe_tpu_torch.models.encoder import Encoder
from matrix_fhe_tpu_torch.ops.ntt import XNTT, apply_gl_perm
from matrix_fhe_tpu_torch.ops.wcrt import WTransform
from matrix_fhe_tpu_torch.tables import build_tables


def _u64(t: torch.Tensor) -> np.ndarray:
    return t.numpy().view(np.uint64)


def _exact_exp2(mp):
    """XLA:CPU's exp2 is an ulp off at most integer exponents
    (test_torch_kernels.exact_exp2): exact powers of two on the JAX side."""
    mp.setattr(jnp, "exp2", lambda e: jnp.ldexp(jnp.ones_like(e),
                                                e.astype(jnp.int32)))


# -- the lane encoder --------------------------------------------------------------

def test_lane_encoder_roundtrip():
    """tests/test_encode_decode.py::test_lane_encoder_roundtrip on the
    port: one [n, n] lane, encode -> decode_lane_from_rns_eval < 0.05 at
    tiny's Delta = 2^12; residues [L, n, n] within one unit of JAX's f64
    route (the fixed-point sandwich is the more exact of the two), the
    decode within 1e-9 of JAX's on the same residues."""
    p = get_params("tiny")
    enc, jenc = Encoder(p, device="cpu"), JaxEncoder(jax_params("tiny"))
    rng = np.random.default_rng(5)
    re = rng.uniform(-3, 3, size=(p.n, p.n))
    im = rng.uniform(-3, 3, size=(p.n, p.n))
    rr, ri = enc.encode(torch.from_numpy(re), torch.from_numpy(im))
    assert rr.shape == (p.num_limbs, p.n, p.n)
    jr, ji = jenc.encode(jnp.asarray(re), jnp.asarray(im))
    for got, want in ((rr, jr), (ri, ji)):
        q = np.array(p.moduli, dtype=object).reshape(-1, 1, 1)
        d = (got.numpy().astype(object) - np.asarray(want).astype(object)) % q
        d = np.where(d > q // 2, d - q, d)
        assert np.abs(d).max() <= 1
    dr, di = enc.decode_lane_from_rns_eval(rr, ri)
    assert np.hypot(dr.numpy() - re, di.numpy() - im).max() < 0.05
    wr, wi = jenc.decode_lane_from_rns_eval(jnp.asarray(_u64(rr)),
                                            jnp.asarray(_u64(ri)))
    assert np.abs(dr.numpy() - np.asarray(wr)).max() <= 1e-9
    assert np.abs(di.numpy() - np.asarray(wi)).max() <= 1e-9


def test_lane_encoder_batch_matches_jax_fixed_point(monkeypatch):
    """On a [W, n, n] batch the JAX encode runs the same fixed-point
    sandwich (MFHE_FP_TRANSFORMS=1, the Pallas kernel in interpret mode);
    with an exact exp2 the residues are bit for bit."""
    monkeypatch.setenv("MFHE_FP_TRANSFORMS", "1")
    _exact_exp2(monkeypatch)
    p = get_params("tiny")
    jenc = JaxEncoder(jax_params("tiny"))
    assert jenc._fp_vi is not None
    rng = np.random.default_rng(8)
    re = rng.uniform(-3, 3, size=(p.phi, p.n, p.n))
    im = rng.uniform(-3, 3, size=(p.phi, p.n, p.n))
    got = Encoder(p, device="cpu").encode(torch.from_numpy(re),
                                          torch.from_numpy(im))
    want = jenc.encode(jnp.asarray(re), jnp.asarray(im))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(_u64(g), np.asarray(w))


def test_zero_key_full_decrypt_fixture():
    """The reference's isolation fixture (test_encode_decode_wcrt.cu:68-86):
    sk = 0 and ct.a = 0 make decrypt the identity, so the encoded message
    through the whole decrypt_and_decode comes back below 1e-2 at tiny."""
    from matrix_fhe_tpu_torch.models.he import Ciphertext, HEContext, SecretKey

    p = get_params("tiny")
    ctx = HEContext(p, device="cpu")
    rng = np.random.default_rng(2)
    re = rng.uniform(-2, 2, size=(p.phi, p.n, p.n))
    im = rng.uniform(-2, 2, size=(p.phi, p.n, p.n))
    pr, pi = ctx.batched_encoder.encode_to_wntt_eval(torch.from_numpy(re),
                                                     torch.from_numpy(im))
    zeros = torch.zeros_like(pr)
    sk0 = SecretKey(torch.zeros((p.num_limbs, p.phi, p.n), dtype=torch.int64))
    dr, di = ctx.decrypt_and_decode(Ciphertext(pr, zeros),
                                    Ciphertext(pi, zeros), sk0)
    assert np.hypot(dr.numpy() - re, di.numpy() - im).max() < 1e-2


def test_unpack_eval_is_the_identity():
    be = BatchedEncoder(get_params("tiny"), device="cpu")
    a, b = torch.arange(6), torch.arange(3)
    ra, rb = be.unpack_eval(a, b)
    assert ra is a and rb is b


# -- W-CRT --------------------------------------------------------------------------

def test_wcrt_centered_roundtrip_exact():
    """test_wcrt_roundtrip.cu's pattern (w + x + y) % 17 - 8 comes back
    exactly at the one-limb preset (Q < 2^63)."""
    p = get_params("tiny1")
    wt = WTransform(p, device="cpu")
    n, phi = p.n, p.phi
    coeff = ((np.arange(phi)[:, None, None] + np.arange(n)[None, None, :]
              + np.arange(n)[None, :, None]) % 17 - 8).astype(np.int64)
    ev = wt.forward_centered(torch.from_numpy(coeff))
    assert (wt.inverse_centered(ev).numpy() == coeff).all()


@pytest.mark.parametrize("preset", ["tiny1", "tiny", "small"])
def test_wcrt_centered_matches_jax(preset):
    """forward_centered bit for bit with JAX, saturation included (every
    multi-limb preset saturates), and inverse_centered on the same
    centered input."""
    p = get_params(preset)
    wt, jwt = WTransform(p, device="cpu"), JaxW(jax_params(preset),
                                                use_pallas=False)
    rng = np.random.default_rng(3)
    v = rng.integers(-8, 9, size=(p.phi, 2, 3)).astype(np.int64)
    got = wt.forward_centered(torch.from_numpy(v)).numpy()
    want = np.asarray(jwt.forward_centered(jnp.asarray(v)))
    np.testing.assert_array_equal(got, want)
    if p.num_limbs > 1:
        assert (np.abs(got) == 2 ** 63 - 1).any() or (got == -2 ** 63).any()
    x = rng.integers(-(1 << 40), 1 << 40, size=(p.phi, 2, 3)).astype(np.int64)
    np.testing.assert_array_equal(
        wt.inverse_centered(torch.from_numpy(x)).numpy(),
        np.asarray(jwt.inverse_centered(jnp.asarray(x))))


@pytest.mark.parametrize("preset", ["tiny", "small"])
def test_inverse_scaled_matches_jax(preset):
    """inverse() premultiplied by M_l^-1 mod q_l, bit for bit (JAX's
    inverse_scaled on the CPU route)."""
    p = get_params(preset)
    wt = WTransform(p, device="cpu")
    jwt = JaxW(jax_params(preset), use_pallas=False, fast_float=True)
    rng = np.random.default_rng(4)
    x = np.stack([rng.integers(0, int(q), (p.phi, 2, p.n), dtype=np.uint64)
                  for q in p.moduli])
    got = wt.inverse_scaled(torch.from_numpy(x.view(np.int64)))
    np.testing.assert_array_equal(_u64(got),
                                  np.asarray(jwt.inverse_scaled(jnp.asarray(x))))


@pytest.mark.parametrize("direction", ["inverse", "forward"])
def test_dft_words_match_jax(monkeypatch, direction):
    """dft_inverse_words / dft_forward_words: the W-(I)DFT of an f64 pair
    as fixed-point words, (m0, m1, m2, sg) re and im and e_scale, bit for
    bit with JAX's fixed-point route (MFHE_FP_TRANSFORMS=1, exact exp2)."""
    monkeypatch.setenv("MFHE_FP_TRANSFORMS", "1")
    _exact_exp2(monkeypatch)
    p = get_params("tiny")
    wt = WTransform(p, device="cpu")
    jwt = JaxW(jax_params("tiny"), use_pallas=False, fast_float=True)
    assert jwt.dft_words_available(p.n * p.n)
    rng = np.random.default_rng(6)
    re, im = (rng.uniform(-3, 3, (p.phi, p.n, p.n)) for _ in range(2))
    name = f"dft_{direction}_words"
    got = getattr(wt, name)(torch.from_numpy(re), torch.from_numpy(im))
    want = getattr(jwt, name)(jnp.asarray(re), jnp.asarray(im))
    for g, w in zip(got[0] + got[1], want[0] + want[1]):
        np.testing.assert_array_equal(g.numpy(),
                                      np.asarray(w).astype(np.int64))
    assert int(got[2]) == int(want[2])
    assert int(got[0][3].sum()) not in (0, got[0][3].numel())   # both signs


# -- X-NTT ----------------------------------------------------------------------------

@pytest.mark.parametrize("ring", ["nega", "gl", "gl2"])
def test_wrap_constant_matches_jax(ring):
    p = get_params("small")
    xn = XNTT(p, ring=ring, device="cpu")
    jxn = jntt.XNTT(jax_params("small"), ring=ring, use_pallas=False)
    for l, q in enumerate(p.moduli):
        w = xn.wrap_constant(l)
        assert w == jxn.wrap_constant(l)
        if ring == "gl":       # X^n = psi4n^n, a square root of -1
            assert w * w % q == q - 1


def test_gl_perm_matches_jax_and_roundtrips():
    p = get_params("small")
    t = build_tables(p)
    x = np.random.default_rng(9).integers(0, 100, size=(3, p.n),
                                          dtype=np.uint64)
    xt = torch.from_numpy(x.view(np.int64))
    y = apply_gl_perm(xt, t.gl_perm)
    np.testing.assert_array_equal(
        _u64(y), np.asarray(jntt.apply_gl_perm(jnp.asarray(x), t.gl_perm)))
    assert torch.equal(apply_gl_perm(y, t.gl_inv_perm), xt)
    # the forward map puts index j at bit_reverse((5^j - 1) / 4)
    e, logn = 1, p.n.bit_length() - 1
    for j in range(p.n):
        idx = (e - 1) // 4
        assert int(t.gl_perm[j]) == int(
            bin(idx + (1 << logn))[3:][::-1], 2)
        e = e * 5 % (4 * p.n)


# -- the *_streamed names ------------------------------------------------------------

def test_multiply_relinearize_streamed_matches_jax():
    """RelinContext.multiply_relinearize_streamed == the port's one route
    == JAX's streamed multiply, on converted keys and ciphertexts."""
    from matrix_fhe_tpu.models import keyswitch as jks
    from matrix_fhe_tpu.models import rng as jrng
    from matrix_fhe_tpu.models.he import HEContext as JaxContext
    from matrix_fhe_tpu_torch.models import keyswitch as tks
    from matrix_fhe_tpu_torch.models.he import HEContext

    jp, p = jax_params("tiny"), get_params("tiny")
    jctx = JaxContext(jp, ring="nega")
    jrc = jks.RelinContext(jctx)
    rc = tks.RelinContext(HEContext(p, device="cpu"))
    jsk = jctx.generate_secret_key()
    jrlk = jrc.gen_relin_key(jnp.asarray(jrng.ternary_secret(jp)),
                             jax.random.key(5))
    c = np.random.default_rng(1).integers(0, 1 << 14, (p.phi, p.n, p.n))
    m = jctx.wt.forward(jnp.asarray(np.stack(
        [(c % int(q)).astype(np.uint64) for q in p.moduli])))
    jct = jctx.encrypt(m, jsk)
    want = jrc.multiply_relinearize_streamed(jct, jct, jrlk)
    ct, rlk = convert.ciphertext(jct), convert.relin_key(jrlk)
    got = rc.multiply_relinearize_streamed(ct, ct, rlk)
    same = rc.multiply_relinearize(ct, ct, rlk)
    for g, s, w in ((got.b, same.b, want.b), (got.a, same.a, want.a)):
        assert torch.equal(g, s)
        np.testing.assert_array_equal(_u64(g), np.asarray(w))


def test_relinearize_streamed_matches_jax():
    """Gl2GemmRelin.relinearize_streamed == relinearize == JAX's
    relinearize_streamed at 1-limb chunks, on a converted tensor and
    switch keys."""
    from matrix_fhe_tpu.models.he2 import Gl2Context as JaxGl2Context
    from matrix_fhe_tpu.models.he_matmul2 import Gl2GemmRelin as JaxRelin
    from matrix_fhe_tpu.models.he_matmul2 import HEMatmul2 as JaxHEMatmul2
    from matrix_fhe_tpu_torch.models.he2 import Gl2Context
    from matrix_fhe_tpu_torch.models.he_matmul2 import Gl2GemmRelin, HEMatmul2

    jp = jax_params("tiny")
    jctx = JaxGl2Context(jp, use_pallas=False)
    jhm = JaxHEMatmul2(jctx)
    rng = np.random.default_rng(31)
    X, Y = (rng.uniform(-2, 2, (jp.phi, jp.n, jp.n)) for _ in range(2))
    jsk = jctx.generate_secret_key(jax.random.key(1))
    cts = [jctx.encrypt(jctx.encode(jnp.asarray(M), jnp.asarray(-M)), jsk,
                        jax.random.key(s)) for M, s in ((X, 2), (Y, 4))]
    jgr = JaxRelin(jhm)
    jks_ = jgr.gen_keys(jsk, jax.random.key(9))
    jtt = jhm.tensor_fn(*cts)
    tt, ks = convert.gemm_tensor2(jtt), convert.gemm_relin_key(jks_)
    mp = pytest.MonkeyPatch()
    mp.setenv("MFHE_GEMM2_CHUNK", "1")
    try:
        want = jgr.relinearize_streamed(jtt, jks_)     # consumes jtt
    finally:
        mp.undo()
    gr = Gl2GemmRelin(HEMatmul2(Gl2Context(get_params("tiny"), device="cpu")),
                      chunk_limbs=1)
    got = gr.relinearize_streamed(tt, ks)
    same = gr.relinearize(tt, ks)
    for g, s, w in ((got.b, same.b, want.b), (got.a, same.a, want.a)):
        assert torch.equal(g, s)
        np.testing.assert_array_equal(_u64(g), np.asarray(w))
