"""Port gl2 ring and GEMM tensor (tables, XNTT, Gl2Context, HEMatmul2)
against the JAX package.

On the CPU kernels K1, K2, K4 and K7 run their plain versions.  Residues
(tables, transforms, plaintexts, ciphertexts, GEMM tensors) must match bit
for bit, and decoded floats too: the JAX side runs with use_pallas=False,
its fixed-point transforms on (MFHE_FP_TRANSFORMS=1, the port's one route)
and an exact exp2 (XLA:CPU's is off by an ulp at integer exponents,
ROADMAP section 3).  JAX keys and ciphertexts are carried across with
matrix_fhe_tpu_torch.convert.  The relinearization is in
test_torch_gl2_relin.py.
"""

import dataclasses
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_workers  # noqa: F401
from matrix_fhe_tpu import tables as jtables
from matrix_fhe_tpu.config import REF_P_MODULI
from matrix_fhe_tpu.config import get_params as jax_params
from matrix_fhe_tpu.models import keyswitch as jks
from matrix_fhe_tpu.models.he2 import Gl2Context as JaxGl2Context
from matrix_fhe_tpu.models.he_matmul2 import HEMatmul2 as JaxHEMatmul2
from matrix_fhe_tpu.ops.ntt import XNTT as JaxXNTT
from matrix_fhe_tpu_torch import convert
from matrix_fhe_tpu_torch.config import get_params
from matrix_fhe_tpu_torch.models.he2 import Gl2Context
from matrix_fhe_tpu_torch.models.he_matmul2 import HEMatmul2, _sigma_index_maps
from matrix_fhe_tpu_torch.ops import modmath as tmm
from matrix_fhe_tpu_torch.ops.modmath import find_psi_4n
from matrix_fhe_tpu_torch.ops.ntt import XNTT
from matrix_fhe_tpu_torch.tables import build_gl2_x_tables, build_tables


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


def _exact_exp2(e):
    return jnp.ldexp(jnp.ones_like(e), e.astype(jnp.int32))


def _messages(p, seed, scale=2.0):
    rng = np.random.default_rng(seed)
    W, n = p.phi, p.n
    return [rng.uniform(-scale, scale, (W, n, n))
            + 1j * rng.uniform(-scale, scale, (W, n, n)) for _ in range(2)]


def _err(pair, want) -> float:
    return float(np.hypot(pair[0].numpy() - want.real,
                          pair[1].numpy() - want.imag).max())


# -- tables and the gl2 X transform -----------------------------------------------

def _qp_params(preset):
    """The JAX RelinContext's QP basis for a preset, in both packages."""
    jp = jax_params(preset)
    qp = jp.moduli + jks._default_p_moduli(jp)
    return (dataclasses.replace(jp, name=jp.name + "-qp", moduli=qp,
                                p_moduli=()),
            dataclasses.replace(get_params(preset), name=jp.name + "-qp",
                                moduli=qp, p_moduli=()))


@pytest.mark.parametrize("basis", ["tiny", "small", "tiny-qp", "ref-p55"])
def test_gl2_x_tables_match_jax(basis):
    """The dense [L, 2n, 2n] tables of Z[X]/(X^{2n}+1), bit for bit; ref-p55
    is the ref geometry (2n = 128) on its 55-bit P prime alone."""
    if basis == "ref-p55":
        tp = dataclasses.replace(get_params("ref"), name="ref-p55",
                                 moduli=REF_P_MODULI[:1], p_moduli=())
        t = types.SimpleNamespace(params=tp, psi4n=(
            find_psi_4n(REF_P_MODULI[0], tp.n),))
        jt = t
    elif basis == "tiny-qp":
        jp, tp = _qp_params("tiny")
        t, jt = build_tables(tp), jtables.build_tables(jp)
    else:
        t, jt = build_tables(get_params(basis)), jtables.build_tables(
            jax_params(basis))
    got, want = build_gl2_x_tables(t), jtables.build_gl2_x_tables(jt)
    assert got[0].shape == (len(t.params.moduli), 2 * t.params.n,
                            2 * t.params.n)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("basis", ["tiny", "small", "tiny-qp"])
def test_xntt_gl2_matches_jax(basis):
    """forward, inverse and mul_s (K1, K1, K2 plain) on the 2n-point ring."""
    if basis == "tiny-qp":
        jp, tp = _qp_params("tiny")
    else:
        jp, tp = jax_params(basis), get_params(basis)
    m = 2 * tp.n
    x = _residues(tp.moduli, (3, tp.n, m), 1)
    s = _residues(tp.moduli, (3, m), 2)
    jx = JaxXNTT(jp, ring="gl2", use_pallas=False)
    tx = XNTT(tp, ring="gl2", device="cpu")
    _eq(tx.forward(_i64(x)), jx.forward(jnp.asarray(x)))
    _eq(tx.inverse(_i64(x)), jx.inverse(jnp.asarray(x)))
    _eq(tx.mul_s(_i64(x), _i64(s)), jx.mul_s(jnp.asarray(x), jnp.asarray(s)))
    assert torch.equal(tx.inverse(tx.forward(_i64(x))), _i64(x))


# -- the JAX reference objects -------------------------------------------------------

@pytest.fixture(scope="module", params=["tiny", "small"])
def gl2(request):
    """JAX gl2 context (fixed-point transforms, exact exp2), its key,
    plaintexts, ciphertexts and GEMM tensor, and the port context."""
    preset = request.param
    mp = pytest.MonkeyPatch()
    mp.setenv("MFHE_FP_TRANSFORMS", "1")
    mp.setattr(jnp, "exp2", _exact_exp2)
    try:
        jp = jax_params(preset)
        jctx = JaxGl2Context(jp, use_pallas=False)
        jhm = JaxHEMatmul2(jctx)
        X, Y = _messages(jp, 31)
        jmX = jctx.encode(jnp.asarray(X.real), jnp.asarray(X.imag))
        jmY = jctx.encode(jnp.asarray(Y.real), jnp.asarray(Y.imag))
        jsk = jctx.generate_secret_key(jax.random.key(1))
        jctX = jctx.encrypt(jmX, jsk, jax.random.key(2))
        jctY = jctx.encrypt(jmY, jsk, jax.random.key(4))
        jtt = jhm.matmul_tensor(jctX, jctY)
        ctx = Gl2Context(get_params(preset), device="cpu")
        yield types.SimpleNamespace(
            preset=preset, jctx=jctx, jhm=jhm, X=X, Y=Y, jmX=jmX, jsk=jsk,
            jctX=jctX, jctY=jctY, jtt=jtt, ctx=ctx, hm=HEMatmul2(ctx),
            sk=convert.secret_key2(jsk), ctX=convert.ciphertext2(jctX),
            ctY=convert.ciphertext2(jctY))
    finally:
        mp.undo()


def test_secret_key_matches_jax(gl2):
    """The port's key finish on the JAX sign pattern: ternary residues,
    W-CRT, 2n-point X-NTT and storage form, bit for bit."""
    p = gl2.ctx.params
    s_res = Gl2Context._ternary_residues(gl2.sk.s_sign, p.moduli)
    _eq(s_res, JaxGl2Context._ternary_residues(gl2.jsk.s_sign, p.moduli))
    s_ntt = gl2.ctx.xntt.forward(gl2.ctx.wt.forward(s_res))
    assert torch.equal(tmm.to_mont(s_ntt, p.moduli), gl2.sk.s_mont)


def test_encode_matches_jax(gl2):
    """XY-IDFT and W-IDFT on the fixed-point route, quantize, W-CRT: the
    packed plaintext [L, W, n, 2n] bit for bit."""
    got = gl2.ctx.encode(torch.from_numpy(gl2.X.real),
                         torch.from_numpy(gl2.X.imag))
    assert got.shape == (len(gl2.ctx.params.moduli), gl2.ctx.params.phi,
                         gl2.ctx.params.n, 2 * gl2.ctx.params.n)
    _eq(got, gl2.jmX)


def test_decode_matches_jax(gl2):
    """decode with Delta^2 (and Delta at tiny): the exact compose, W-DFT
    and XY sandwich bit for bit on the same plaintext."""
    p = gl2.ctx.params
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jnp, "exp2", _exact_exp2)
        deltas = (None, float(p.delta) ** 2) if gl2.preset == "tiny" else \
            (float(p.delta) ** 2,)
        for delta in deltas:
            want = gl2.jctx.decode_fn(gl2.jmX, delta_override=delta)
            got = gl2.ctx.decode(_i64(gl2.jmX), delta_override=delta)
            for g, w in zip(got, want):
                np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert _err(gl2.ctx.decode(_i64(gl2.jmX)), gl2.X) < 2e-2


def test_encrypt_on_jax_randomness_matches_jax(gl2):
    """encrypt given the JAX draws of `a` and the noise: (b, a) bit for bit;
    decrypt_to_eval of the JAX ciphertext equals JAX's."""
    jctx, p = gl2.jctx, gl2.ctx.params
    ka, ke = jax.random.split(jax.random.key(2))
    frame = (p.phi, p.n, 2 * p.n)
    a = jctx._fresh_uniform(ka, frame)
    e = jctx._fresh_gaussian(ke, frame)
    got = gl2.ctx._encrypt_from(_i64(gl2.jmX), gl2.sk, _i64(a), _i64(e))
    _eq(got.b, gl2.jctX.b)
    _eq(got.a, gl2.jctX.a)
    _eq(gl2.ctx.decrypt_to_eval(gl2.ctX, gl2.sk),
        jctx.decrypt_to_eval(gl2.jctX, gl2.jsk))


# -- HEMatmul2 --------------------------------------------------------------------------

def test_sigma_index_maps_match_jax():
    from matrix_fhe_tpu.models.he_matmul2 import _sigma_index_maps as jmaps
    for n in (8, 16, 64):
        for g, w in zip(_sigma_index_maps(n), jmaps(n)):
            np.testing.assert_array_equal(g, w)


def test_tensor_fn_matches_jax(gl2):
    """sigma, RY, TW and the four n-scaled GEMMs (K7's plain version) on
    JAX ciphertexts, bit for bit."""
    tt = gl2.hm.tensor_fn(gl2.ctX, gl2.ctY)
    for g, w in zip(tt, gl2.jtt):
        _eq(g, w)


def test_decrypt_tensor_and_repack_match_jax(gl2):
    tt = convert.gemm_tensor2(gl2.jtt)
    _eq(gl2.hm.decrypt_tensor_fn(tt, gl2.sk),
        gl2.jhm.decrypt_tensor_fn(gl2.jtt, gl2.jsk))
    _eq(gl2.hm.repack_fn(tt.e11), gl2.jhm.repack_fn(gl2.jtt.e11))
