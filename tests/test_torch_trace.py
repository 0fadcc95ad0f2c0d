"""Port trace-GEMM path (gint, crt, trace, he_matmul and the Delta^2 decode)
against the JAX package.

On the CPU kernel K6 runs its plain version.  Residues and decoded floats
must match bit for bit (the JAX decode with an exact exp2); the
end-to-end error is held to the JAX test's bound.  Ciphertexts and keys are
made by the JAX package (jax.random keys) and carried across with
matrix_fhe_tpu_torch.convert, since the port draws from torch.Generator.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_workers  # noqa: F401
from matrix_fhe_tpu.config import generate_ntt_primes
from matrix_fhe_tpu.config import get_params as jax_params
from matrix_fhe_tpu.models import trace as jtr
from matrix_fhe_tpu.models.he import HEContext as JaxContext
from matrix_fhe_tpu.models.he_matmul import HEMatmul as JaxHEMatmul
from matrix_fhe_tpu.models.he_matmul import conj_flip_perm as jax_flip
from matrix_fhe_tpu.ops import crt as jcrt
from matrix_fhe_tpu.ops import gint as jgint
from matrix_fhe_tpu.tables import build_tables as jax_tables
from matrix_fhe_tpu_torch import convert
from matrix_fhe_tpu_torch.config import get_params
from matrix_fhe_tpu_torch.models import trace as ttr
from matrix_fhe_tpu_torch.models.he import HEContext
from matrix_fhe_tpu_torch.models.he_matmul import HEMatmul, conj_flip_perm
from matrix_fhe_tpu_torch.ops import crt as tcrt
from matrix_fhe_tpu_torch.ops import gint as tgint
from matrix_fhe_tpu_torch.ops.cgemm import CGemm
from matrix_fhe_tpu_torch.tables import build_tables


def _residues(moduli, shape, seed):
    rng = np.random.default_rng(seed)
    return np.stack([rng.integers(0, int(q), size=shape, dtype=np.uint64)
                     for q in moduli])


def _i64(x) -> torch.Tensor:
    return convert.residues(x)


def _eq(got: torch.Tensor, want) -> None:
    np.testing.assert_array_equal(got.numpy().view(np.uint64)
                                  if got.dtype == torch.int64 else got.numpy(),
                                  np.asarray(want))


# -- gint --------------------------------------------------------------------------

def test_gint_ops_match_jax():
    p = get_params("tiny")
    a = [_residues(p.moduli, (5, 3), s) for s in (1, 2)]
    b = [_residues(p.moduli, (5, 3), s) for s in (3, 4)]
    ja = jgint.GaussianIntRNS(*(jnp.asarray(x) for x in a))
    jb = jgint.GaussianIntRNS(*(jnp.asarray(x) for x in b))
    ta = tgint.GaussianIntRNS(*(_i64(x) for x in a))
    tb = tgint.GaussianIntRNS(*(_i64(x) for x in b))
    for op in ("add", "sub", "mul"):
        got = getattr(tgint, op)(ta, tb, p.moduli)
        want = getattr(jgint, op)(ja, jb, p.moduli)
        _eq(got.x, want.x)
        _eq(got.y, want.y)
    for op in ("conj", "mul_by_neg_i"):
        got = getattr(tgint, op)(ta, p.moduli)
        want = getattr(jgint, op)(ja, p.moduli)
        _eq(got.x, want.x)
        _eq(got.y, want.y)


# -- CRT compose -------------------------------------------------------------------

def _compose_inputs(p, count, seed):
    """Residues of centered int64 values (near 2^62 and small), of values
    anywhere in [0, Q), and of the center boundary."""
    rng = np.random.default_rng(seed)
    Q = p.q_total
    vals = [int(v) for v in rng.integers(-(1 << 62), 1 << 62, count // 4)]
    vals += [int(v) for v in rng.integers(-(1 << 20), 1 << 20, count // 4)]
    vals += [int.from_bytes(rng.bytes(64), "little") % Q
             for _ in range(count // 2)]
    vals += [Q // 2, Q // 2 + 1, Q - 1, 0, 1, -1]
    return np.stack([np.array([v % q for v in vals], dtype=np.uint64)
                     for q in p.moduli])


@pytest.mark.parametrize("preset,count", [("tiny", 512), ("mid", 4096)])
def test_crt_composes_match_jax(preset, count):
    p = get_params(preset)
    rns = _compose_inputs(p, count, seed=len(preset))
    jc = jcrt.CRTComposer(jax_tables(jax_params(preset)))
    tc = tcrt.CRTComposer(build_tables(p))
    x, jx = _i64(rns), jnp.asarray(rns)
    jmag, jneg = jc.compose_magnitude(jx)
    tmag, tneg = tc.compose_magnitude(x)
    assert len(tmag) == len(jmag)
    for t, j in zip(tmag, jmag):
        np.testing.assert_array_equal(t.numpy(), np.asarray(j).astype(np.int64))
    np.testing.assert_array_equal(tneg.numpy(), np.asarray(jneg))
    for delta in (1.0, p.delta, p.delta ** 2):
        np.testing.assert_array_equal(tc.compose_to_float(x, delta).numpy(),
                                      np.asarray(jc.compose_to_float(jx, delta)))
    cent = tc.compose_centered_i64(x).numpy()
    np.testing.assert_array_equal(cent, np.asarray(jc.compose_centered_i64(jx)))
    assert (np.abs(cent) < (1 << 62)).any() and (cent == (1 << 63) - 1).any()
    for delta in (p.delta, p.delta ** 2):
        np.testing.assert_array_equal(
            tc.compose_round_div_delta_i64(x, delta).numpy(),
            np.asarray(jc.compose_round_div_delta_i64(jx, delta)))


def test_centered_i64_to_rns_matches_jax():
    p = get_params("tiny")
    rng = np.random.default_rng(3)
    x = rng.integers(-(1 << 62), 1 << 62, (4, 8))
    _eq(tcrt.centered_i64_to_rns(torch.from_numpy(x), p.moduli),
        jcrt.centered_i64_to_rns(jnp.asarray(x), p.moduli))


def test_delta_squared_values_pass_2_63_and_compose_exactly():
    """At mid (Delta = 2^35, four ref limbs) a Delta^2-scaled product
    x * 2^70 with |x| up to 8 lies far outside +-2^63, where the fused
    mod-2^64 compose of the roundtrip decode (kernel K3) cannot recover it.
    The exact compose (the Delta^2 decode route) equals the JAX one bit for
    bit there and returns x to within f64 rounding."""
    p = get_params("mid")
    rng = np.random.default_rng(11)
    xs = rng.uniform(-8, 8, 3000)
    vals = [int(round(x * 2.0 ** 35)) * (1 << 35) for x in xs]
    assert max(abs(v) for v in vals) > 1 << 63
    rns = np.stack([np.array([v % q for v in vals], dtype=np.uint64)
                    for q in p.moduli])
    tc = tcrt.CRTComposer(build_tables(p))
    jc = jcrt.CRTComposer(jax_tables(jax_params("mid")))
    d2 = p.delta ** 2
    got = tc.compose_to_float(_i64(rns), d2).numpy()
    np.testing.assert_array_equal(got, np.asarray(jc.compose_to_float(
        jnp.asarray(rns), d2)))
    np.testing.assert_allclose(got, xs, rtol=0, atol=2.0 ** -34)
    mag, _ = tc.compose_magnitude(_i64(rns))
    assert bool((mag[2] != 0).any())          # some |value| >= 2^64
    # the low 64 bits alone (what a mod-2^64 compose keeps) are wrong there
    low = (mag[0] | (mag[1] << 32)).numpy().astype(np.float64) / d2
    assert np.abs(np.abs(low) - np.abs(xs)).max() > 1


# -- trace GEMM ---------------------------------------------------------------------

@pytest.fixture(scope="module")
def operands():
    p = get_params("tiny")
    return p, [_residues(p.moduli, (4, p.n, p.n), s) for s in range(4)]


def test_map_b_to_bprime_matches_jax(operands):
    p, (_, _, br, bi) = operands
    want = jtr.map_b_to_bprime(jnp.asarray(br), jnp.asarray(bi),
                               jax_params("tiny"))
    got = ttr.map_b_to_bprime(_i64(br), _i64(bi), p)
    _eq(got[0], want[0])
    _eq(got[1], want[1])


def test_trace_gemm_matches_jax(operands):
    """The port's trace_gemm (K6's plain version) against the JAX XLA
    route, and trace_matmul (map, GEMM, rescale) end to end."""
    p, (ar, ai, br, bi) = operands
    jp = jax_params("tiny")
    want = jtr.trace_gemm(*(jnp.asarray(x) for x in (ar, ai, br, bi)), jp)
    got = ttr.trace_gemm(*(_i64(x) for x in (ar, ai, br, bi)), p)
    _eq(got[0], want[0])
    _eq(got[1], want[1])
    want = jtr.trace_matmul(*(jnp.asarray(x) for x in (ar, ai, br, bi)), jp)
    got = ttr.trace_matmul(*(_i64(x) for x in (ar, ai, br, bi)), p)
    _eq(got[0], want[0])
    _eq(got[1], want[1])


def test_rescale_by_delta_matches_jax(operands):
    p, (ar, ai, _, _) = operands
    want = jtr.rescale_by_delta(jnp.asarray(ar), jnp.asarray(ai),
                                jax_params("tiny"))
    got = ttr.rescale_by_delta(_i64(ar), _i64(ai), p)
    _eq(got[0], want[0])
    _eq(got[1], want[1])


def test_cgemm_matches_sliced_cgemm_interpret(monkeypatch):
    """Against the TPU kernel (SlicedCGemm in interpret mode, selected by
    MFHE_CGEMM=sliced as tests/test_trace.py does), including a 45 + 35-bit
    limb chain like ref's."""
    monkeypatch.setenv("MFHE_CGEMM", "sliced")
    p0 = jax_params("tiny")
    m45 = (generate_ntt_primes(1, 45, p0.n, p0.p)
           + generate_ntt_primes(2, 35, p0.n, p0.p))
    for jp in (p0, dataclasses.replace(p0, name="tiny45x", moduli=m45)):
        ops = [_residues(jp.moduli, (jp.phi, jp.n, jp.n), s) for s in (5, 6, 7, 8)]
        want = jtr.trace_gemm(*(jnp.asarray(x) for x in ops), jp)
        got = CGemm(jp.moduli, jp.n, "cpu")(*(_i64(x) for x in ops))
        _eq(got[0], want[0])
        _eq(got[1], want[1])


# -- HEMatmul -------------------------------------------------------------------------

def _messages(p, seed):
    rng = np.random.default_rng(seed)
    W, n = p.phi, p.n
    return [rng.uniform(-1, 1, (W, n, n)) + 1j * rng.uniform(-1, 1, (W, n, n))
            for _ in range(2)]


@pytest.fixture(scope="module")
def matmul_setup():
    """JAX gl context with the fixed-point transforms on (the port's decode
    route), its keys and ciphertexts, and the port context."""
    mp = pytest.MonkeyPatch()
    mp.setenv("MFHE_FP_TRANSFORMS", "1")
    try:
        jp = jax_params("tiny")
        jctx = JaxContext(jp, ring="gl")
        jhm = JaxHEMatmul(jctx)
    finally:
        mp.undo()
    A, B = _messages(jp, 5)
    pA = jctx.batched_encoder.encode_to_wntt_eval(jnp.asarray(A.real),
                                                  jnp.asarray(A.imag))
    pB = jctx.batched_encoder.encode_to_wntt_eval(jnp.asarray(B.real),
                                                  jnp.asarray(B.imag))
    jsk = jctx.generate_secret_key(key=jax.random.key(3))
    ctA = jctx.encrypt_pair(*pA, jsk, key=jax.random.key(11))
    ctB = jctx.encrypt_pair(*pB, jsk, key=jax.random.key(12))
    jtt = jhm.matmul(ctA, ctB)
    hm = HEMatmul(HEContext(get_params("tiny"), ring="gl", device="cpu"))
    return jhm, jsk, ctA, ctB, jtt, hm, A, B


def test_conj_flip_perm_matches_jax():
    for preset in ("tiny", "ref"):
        np.testing.assert_array_equal(conj_flip_perm(get_params(preset)),
                                      jax_flip(jax_params(preset)))


def test_tensor_fn_matches_jax(matmul_setup):
    _, _, ctA, ctB, jtt, hm, _, _ = matmul_setup
    tt = hm.matmul(tuple(convert.ciphertext(c) for c in ctA),
                   tuple(convert.ciphertext(c) for c in ctB))
    for g, w in zip(tt, jtt):
        _eq(g, w)


def test_decrypt_fn_matches_jax(matmul_setup):
    jhm, jsk, _, _, jtt, hm, _, _ = matmul_setup
    want = jhm.decrypt_fn(jtt, jsk)
    got = hm.decrypt_fn(convert.matmul_tensor(jtt), convert.secret_key(jsk))
    _eq(got[0], want[0])
    _eq(got[1], want[1])


def test_decrypt_and_decode_matches_jax(matmul_setup, monkeypatch):
    """The Delta^2 decode (W-CRT inverse, exact compose, fixed-point W-DFT
    and XY sandwich) against the JAX route with the fixed-point transforms
    on, bit for bit once the JAX side has an exact exp2 (XLA:CPU's is off
    by an ulp at most integer exponents, ROADMAP section 3)."""
    monkeypatch.setattr(jnp, "exp2", lambda e: jnp.ldexp(
        jnp.ones_like(e), e.astype(jnp.int32)))
    jhm, jsk, _, _, jtt, hm, _, _ = matmul_setup
    want = jhm.decrypt_and_decode(jtt, jsk)
    got = hm.decrypt_and_decode(convert.matmul_tensor(jtt),
                                convert.secret_key(jsk))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_homomorphic_matmul_end_to_end():
    """Port-only: encode, encrypt with a torch.Generator, tensor, decrypt,
    decode ~= Y^H X.  tiny's Delta = 2^12 bounds the error by 0.35
    (tests/test_he_matmul.py:90)."""
    p = get_params("tiny")
    ctx = HEContext(p, ring="gl", device="cpu")
    hm = HEMatmul(ctx)
    gen = torch.Generator().manual_seed(3)
    sk = ctx.generate_secret_key(gen)
    A, B = _messages(p, 6)
    cts = []
    for M in (A, B):
        pr, pi = ctx.batched_encoder.encode_to_wntt_eval(
            torch.from_numpy(M.real), torch.from_numpy(M.imag))
        cts.append(ctx.encrypt_pair(pr, pi, sk, generator=gen))
    dr, di = hm.decrypt_and_decode(hm.matmul(*cts), sk)
    C = dr.numpy() + 1j * di.numpy()
    ref = np.conj(np.swapaxes(B, 1, 2)) @ A
    assert np.isfinite(C).all() and C.shape == ref.shape
    assert np.abs(C - ref).max() < 0.35


def test_requires_gl_ring():
    with pytest.raises(ValueError, match="gl"):
        HEMatmul(HEContext(get_params("tiny"), ring="nega", device="cpu"))
