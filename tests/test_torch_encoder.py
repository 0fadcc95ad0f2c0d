"""Port batched encoder against the JAX package's words-chained route.

The port has one encode and one decode route, the JAX package's fast one
(BatchedEncoder.encode_pair / decode_pair with the fixed-point transforms
on, MFHE_FP_TRANSFORMS=1, and the Pallas kernels in interpret mode).  The
same numpy messages go through both.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_workers  # noqa: F401
from matrix_fhe_tpu.config import get_params as jax_params
from matrix_fhe_tpu.models.batched_encoder import BatchedEncoder as JaxEncoder
from matrix_fhe_tpu.ops import modmath as jmm
from matrix_fhe_tpu.ops.wcrt import WTransform as JaxW
from matrix_fhe_tpu_torch.config import get_params
from matrix_fhe_tpu_torch.models.batched_encoder import BatchedEncoder

PRESET = "tiny"


def _message(p, seed=5, scale=4.0):
    rng = np.random.default_rng(seed)
    return (rng.uniform(-scale, scale, (p.phi, p.n, p.n)),
            rng.uniform(-scale, scale, (p.phi, p.n, p.n)))


@pytest.fixture(scope="module")
def encoders():
    """(JAX fast-route encoder, port encoder, message, JAX encode output)."""
    mp = pytest.MonkeyPatch()
    mp.setenv("MFHE_FP_TRANSFORMS", "1")
    try:
        p = jax_params(PRESET)
        jbe = JaxEncoder(p, wt=JaxW(p, use_pallas=True, fast_float=True),
                         fast_float=True)
        assert jbe.wt._fp_idft is not None and jbe.encoder._fp_v is not None
    finally:
        mp.undo()
    re, im = _message(p)
    pairs = jbe.encode_pair(jnp.asarray(re), jnp.asarray(im))
    return jbe, BatchedEncoder(get_params(PRESET), device="cpu"), (re, im), pairs


def test_encode_matches_words_route(encoders):
    """Encoded plaintext residues bit for bit (no exp2 adjustment needed:
    the inexact XLA:CPU scale moves no rounding on these inputs)."""
    _, tbe, (re, im), ((rl, rh), (il, ih)) = encoders
    pr, pi = tbe.encode_to_wntt_eval(torch.from_numpy(re), torch.from_numpy(im))
    np.testing.assert_array_equal(pr.numpy().view(np.uint64),
                                  np.asarray(jmm.pair_join(rl, rh)))
    np.testing.assert_array_equal(pi.numpy().view(np.uint64),
                                  np.asarray(jmm.pair_join(il, ih)))


def _decode_both(encoders):
    jbe, tbe, _, pairs = encoders
    want = jbe.decode_pair(*pairs)
    ev = [torch.from_numpy(
        np.asarray(jmm.pair_join(lo, hi)).view(np.int64).copy())
          for lo, hi in pairs]
    got = tbe.decode_from_wntt_eval(*ev)
    return [np.asarray(w) for w in want], [g.numpy() for g in got]


def test_decode_bit_identical_with_exact_exp2(encoders, monkeypatch):
    """With exact powers of two on the JAX side (XLA:CPU's exp2 is off by
    an ulp at most integer exponents, see test_torch_kernels.exact_exp2),
    the decoded f64 output is bit-identical."""
    monkeypatch.setattr(jnp, "exp2", lambda e: jnp.ldexp(
        jnp.ones_like(e), e.astype(jnp.int32)))
    want, got = _decode_both(encoders)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])


def test_decode_within_1e9_of_jax(encoders):
    """Against the unmodified JAX route the decode differs only by the f64
    ulps of XLA:CPU's exp2 in ExactComplexMatmul.words_to_f64; the bound is
    the one tests/test_pipeline.py:168 holds two JAX routes to."""
    want, got = _decode_both(encoders)
    assert np.abs(got[0] - want[0]).max() <= 1e-9
    assert np.abs(got[1] - want[1]).max() <= 1e-9


def test_loopback_within_contract():
    p = get_params(PRESET)
    tbe = BatchedEncoder(p, device="cpu")
    re, im = _message(p, seed=6, scale=0.9)
    dr, di = tbe.decode_pair(*tbe.encode_pair(torch.from_numpy(re),
                                              torch.from_numpy(im)))
    # tests/test_encode_decode.py: 0.35 at tiny's Delta = 2^12
    assert np.hypot(dr.numpy() - re, di.numpy() - im).max() < 0.35


def test_f64_sandwiches_match_jax():
    """The f64 idft2 / dft2 (kept for tests) against the JAX f64 route."""
    from matrix_fhe_tpu.models.encoder import Encoder as JaxEnc
    from matrix_fhe_tpu_torch.models.encoder import Encoder

    p = get_params(PRESET)
    enc, jenc = Encoder(p, device="cpu"), JaxEnc(jax_params(PRESET))
    re, im = _message(p, seed=7)
    for mine, ref in ((enc.idft2, jenc.idft2), (enc.dft2, jenc.dft2)):
        got = mine(torch.from_numpy(re), torch.from_numpy(im))
        want = ref(jnp.asarray(re), jnp.asarray(im))
        for g, w in zip(got, want):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0,
                                       atol=1e-12)


def test_quantize_words_contract_guard():
    """e_scale <= log2(Delta) (a message beyond the encode contract) raises
    instead of mis-scaling every residue; a compliant scale quantizes."""
    from matrix_fhe_tpu_torch.models.encoder import Encoder

    enc = Encoder(get_params(PRESET), device="cpu")
    words = (torch.ones(2, 8, dtype=torch.int64),) * 3 + (
        torch.zeros(2, 8, dtype=torch.int64),)
    with pytest.raises(ValueError, match="encode contract"):
        enc.quantize_words(words, words, torch.tensor(enc.delta_bits))
    rr, _ = enc.quantize_words(words, words, torch.tensor(enc.delta_bits + 8))
    assert rr.shape == (len(enc.params.moduli), 2, 8) and rr.any()


# -- a Delta that is not a power of two ------------------------------------------

DELTA3 = 3.0 * 2 ** 10


@pytest.fixture(scope="module")
def delta3():
    """Tiny with Delta = 3 * 2^10 in both packages: the JAX encode_pair
    takes its f64 route (delta_bits is None there), the port
    encode_to_wntt_eval its llround route.  The JAX side runs with an exact
    exp2, as test_decode_bit_identical_with_exact_exp2 does.  Returns (port
    encoder, message, JAX residues (re, im), JAX decode of them)."""
    mp = pytest.MonkeyPatch()
    mp.setenv("MFHE_FP_TRANSFORMS", "1")
    mp.setattr(jnp, "exp2", lambda e: jnp.ldexp(
        jnp.ones_like(e), e.astype(jnp.int32)))
    try:
        p = dataclasses.replace(jax_params(PRESET), delta=DELTA3)
        jbe = JaxEncoder(p, wt=JaxW(p, use_pallas=True, fast_float=True),
                         fast_float=True)
        assert jbe.encoder.delta_bits is None and jbe.encoder._fp_vi is not None
        re, im = _message(p)
        pairs = jbe.encode_pair(jnp.asarray(re), jnp.asarray(im))
        want = [np.asarray(w) for w in jbe.decode_pair(*pairs)]
    finally:
        mp.undo()
    res = [np.asarray(jmm.pair_join(lo, hi)) for lo, hi in pairs]
    tbe = BatchedEncoder(dataclasses.replace(get_params(PRESET), delta=DELTA3),
                         device="cpu")
    return tbe, (re, im), res, want


def test_encode_any_delta_matches_jax(delta3):
    """At Delta = 3 * 2^10 the port encodes (idft2_exact, dft_inverse_pair,
    llround(c Delta) mod q, W-CRT) to JAX's residues, bit for bit."""
    tbe, (re, im), res, _ = delta3
    assert not tbe.encoder.words_route
    pr, pi = tbe.encode_to_wntt_eval(torch.from_numpy(re), torch.from_numpy(im))
    np.testing.assert_array_equal(pr.numpy().view(np.uint64), res[0])
    np.testing.assert_array_equal(pi.numpy().view(np.uint64), res[1])


def test_roundtrip_any_delta_matches_jax(delta3):
    """The port's decode of its own encode at Delta = 3 * 2^10 is within
    1e-9 of JAX's decode of JAX's encode, and within 1e-2 of the message
    (JAX's own error there is 6.39e-3)."""
    tbe, (re, im), _, want = delta3
    dr, di = tbe.decode_pair(*tbe.encode_pair(torch.from_numpy(re),
                                              torch.from_numpy(im)))
    assert np.abs(dr.numpy() - want[0]).max() <= 1e-9
    assert np.abs(di.numpy() - want[1]).max() <= 1e-9
    assert np.hypot(dr.numpy() - re, di.numpy() - im).max() < 1e-2


def test_words_route_needs_power_of_two(delta3):
    """Power-of-two presets take the words route; at Delta = 3 * 2^10 the
    words quantize, which needs log2(Delta), refuses to run."""
    from matrix_fhe_tpu_torch.models.encoder import Encoder

    assert Encoder(get_params(PRESET), device="cpu").words_route
    enc = delta3[0].encoder
    words = (torch.ones(2, 8, dtype=torch.int64),) * 4
    with pytest.raises(ValueError, match="power-of-two"):
        enc.quantize_words(words, words, torch.tensor(20))
