"""Port HE scheme (matrix_fhe_tpu_torch.models.he) against the JAX package.

Keys and ciphertexts must match bit for bit, a JAX ciphertext converted
with matrix_fhe_tpu_torch.convert must decrypt in the port, and the whole
ref-path roundtrip must reproduce the JAX _roundtrip_pair_fn.
"""

import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from matrix_fhe_tpu.config import get_params as jax_params
from matrix_fhe_tpu.models.he import HEContext as JaxContext
from matrix_fhe_tpu_torch import convert, init_he_backend
from matrix_fhe_tpu_torch.config import get_params
from matrix_fhe_tpu_torch.models.he import HEContext
from matrix_fhe_tpu_torch.ops.ntt import RING_GL, RING_NEGACYCLIC

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _residues(p, seed):
    rng = np.random.default_rng(seed)
    return np.stack([rng.integers(0, q, (p.phi, p.n, p.n), dtype=np.uint64)
                     for q in p.moduli])


def _t(x):
    return convert.residues(x)


def _message(p, seed):
    rng = np.random.default_rng(seed)
    return (rng.uniform(-4, 4, (p.phi, p.n, p.n)),
            rng.uniform(-4, 4, (p.phi, p.n, p.n)))


@pytest.mark.parametrize("ring", [RING_NEGACYCLIC, RING_GL])
def test_keygen_and_encrypt_pair_match_jax(ring):
    """s_mont and both ciphertexts (b, a) bit for bit."""
    p = get_params("tiny")
    jctx = JaxContext(jax_params("tiny"), ring=ring)
    ctx = HEContext(p, ring=ring)
    jsk, sk = jctx.generate_secret_key(), ctx.generate_secret_key()
    assert torch.equal(sk.s_mont, convert.secret_key(jsk).s_mont)
    m_re, m_im = _residues(p, 1), _residues(p, 2)
    jcts = jctx.encrypt_pair(jnp.asarray(m_re), jnp.asarray(m_im), jsk)
    cts = ctx.encrypt_pair(_t(m_re), _t(m_im), sk)
    for jct, ct in zip(jcts, cts):
        want = convert.ciphertext(jct)
        assert torch.equal(ct.b, want.b) and torch.equal(ct.a, want.a)


@pytest.mark.parametrize("ring", [RING_NEGACYCLIC, RING_GL])
def test_zero_noise_encrypt_decrypt_identity(ring):
    p = get_params("tiny")
    ctx = HEContext(p, ring=ring, zero_noise=True)
    sk = ctx.generate_secret_key()
    m_re, m_im = _t(_residues(p, 3)), _t(_residues(p, 4))
    ev_re, ev_im = ctx.decrypt_pair_to_eval(*ctx.encrypt_pair(m_re, m_im, sk),
                                            sk)
    assert torch.equal(ev_re, m_re) and torch.equal(ev_im, m_im)


def test_decrypt_jax_ciphertext():
    """A ciphertext and key made by the JAX package, converted, decrypt in
    the port to the JAX decryption and decode to the message."""
    jp = jax_params("tiny")
    jctx = JaxContext(jp)
    jsk = jctx.generate_secret_key()
    re, im = _message(jp, 5)
    pr, pi = jctx.batched_encoder.encode_to_wntt_eval(jnp.asarray(re),
                                                      jnp.asarray(im))
    jct_re, jct_im = jctx.encrypt_pair(pr, pi, jsk)
    want = jctx.decrypt_pair_to_eval(jct_re, jct_im, jsk)

    ctx = HEContext(get_params("tiny"))
    sk = convert.secret_key(jsk)
    ct_re, ct_im = convert.ciphertext(jct_re), convert.ciphertext(jct_im)
    got = ctx.decrypt_pair_to_eval(ct_re, ct_im, sk)
    for g, w in zip(got, want):
        assert torch.equal(g, _t(w))
    dr, di = ctx.decrypt_and_decode(ct_re, ct_im, sk)
    # tests/test_pipeline.py: 0.5 at tiny's Delta = 2^12
    assert np.hypot(dr.numpy() - re, di.numpy() - im).max() < 0.5


def test_roundtrip_matches_jax_roundtrip_pair_fn(monkeypatch):
    """The whole roundtrip at small against the JAX fast path
    (_roundtrip_pair_fn with interpret-mode Pallas kernels and the
    fixed-point transforms), bit for bit.  The JAX side gets exact powers
    of two: XLA:CPU's exp2 is off by an ulp at most integer exponents,
    which alone moves the decoded f64 output by ulps (see
    test_torch_encoder.test_decode_within_1e9_of_jax)."""
    monkeypatch.setenv("MFHE_FP_TRANSFORMS", "1")
    monkeypatch.setattr(jnp, "exp2", lambda e: jnp.ldexp(
        jnp.ones_like(e), e.astype(jnp.int32)))
    jp = jax_params("small")
    jctx = JaxContext(jp, use_pallas=True, fast_float=True)
    jsk = jctx.generate_secret_key()
    re, im = _message(jp, 3)
    want = jctx._roundtrip_pair_fn(jnp.asarray(re), jnp.asarray(im), jsk)

    ctx = HEContext(get_params("small"))
    got = ctx.roundtrip(torch.from_numpy(re), torch.from_numpy(im),
                        ctx.generate_secret_key())
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    assert np.hypot(got[0].numpy() - re, got[1].numpy() - im).max() < 0.05


def test_step_api_equals_roundtrip():
    p = get_params("tiny")
    ctx = init_he_backend("tiny")
    assert init_he_backend("tiny") is ctx
    sk = ctx.generate_secret_key()
    re, im = (torch.from_numpy(x) for x in _message(p, 6))
    pr, pi = ctx.batched_encoder.encode_to_wntt_eval(re, im)
    steps = ctx.decrypt_and_decode(*ctx.encrypt_pair(pr, pi, sk), sk)
    fused = ctx.roundtrip(re, im, sk)
    assert torch.equal(steps[0], fused[0]) and torch.equal(steps[1], fused[1])


def test_fresh_randomness_pipeline():
    p = get_params("tiny")
    ctx = HEContext(p)
    gen = torch.Generator().manual_seed(42)
    sk = ctx.generate_secret_key(gen)
    assert not torch.equal(sk.s_mont, ctx.generate_secret_key().s_mont)
    re, im = (torch.from_numpy(x) for x in _message(p, 7))
    pr, pi = ctx.batched_encoder.encode_to_wntt_eval(re, im)
    ct_re, ct_im = ctx.encrypt_pair(pr, pi, sk, generator=gen)
    assert torch.equal(ct_re.a, ct_im.a)
    dr, di = ctx.decrypt_and_decode(ct_re, ct_im, sk)
    assert np.hypot((dr - re).numpy(), (di - im).numpy()).max() < 0.5


def test_package_never_imports_jax():
    code = ("import sys, matrix_fhe_tpu_torch as m; "
            "from matrix_fhe_tpu_torch import convert; "
            "from matrix_fhe_tpu_torch.ops import ntt_large, crt, gint, cgemm, "
            "rns_ext; "
            "from matrix_fhe_tpu_torch.models import trace, he_matmul, he2, "
            "he_matmul2, keyswitch; "
            "ctx = m.init_he_backend('tiny'); ctx.generate_secret_key(); "
            "m.HEMatmul(m.init_he_backend('tiny', ring='gl')); "
            "m.Gl2GemmRelin(m.HEMatmul2(m.Gl2Context(m.get_params('tiny')))); "
            "bad = [k for k in sys.modules "
            "if k == 'jax' or k.startswith(('jax.', 'matrix_fhe_tpu.')) "
            "or k == 'matrix_fhe_tpu']; "
            "assert not bad, bad")
    env = dict(os.environ, PYTHONPATH=ROOT)
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


def test_chip_smoke_fails_without_cuda(tmp_path):
    """chip_smoke.py exits nonzero and prints no result line on a host
    without CUDA, from the repo and from a directory holding only it."""
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA")
    alone = tmp_path / "chip_smoke.py"
    alone.write_text(open(os.path.join(ROOT, "chip_smoke.py")).read())
    for script in (os.path.join(ROOT, "chip_smoke.py"), str(alone)):
        proc = subprocess.run([sys.executable, script],
                              cwd=os.path.dirname(script),
                              capture_output=True, text=True, timeout=120)
        assert proc.returncode != 0
        assert '"ok"' not in proc.stdout


def test_cuda_backend_raises_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        init_he_backend("tiny", device="cuda")
