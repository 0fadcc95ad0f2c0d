"""Port gl2 conjugation (models/he_matmul2.Gl2Conj) against the JAX package.

The switch key's target sigma(s) and the conjugated ciphertext on a
converted JAX key must match bit for bit; the port's own key, drawn from a
torch.Generator, must decode to conj(X) within the JAX test's bound
(tests/test_he_matmul2.py::test_gl2_x_slot_rotation_and_conjugation).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_workers  # noqa: F401
from matrix_fhe_tpu.config import get_params as jax_params
from matrix_fhe_tpu.models import keyswitch as jks
from matrix_fhe_tpu.models.he2 import Gl2Context as JaxGl2Context
from matrix_fhe_tpu.models.he_matmul2 import Gl2Conj as JaxGl2Conj
from matrix_fhe_tpu.models.he_matmul2 import HEMatmul2 as JaxHEMatmul2
from matrix_fhe_tpu_torch import convert
from matrix_fhe_tpu_torch.config import get_params
from matrix_fhe_tpu_torch.models.he2 import Gl2Context
from matrix_fhe_tpu_torch.models.he_matmul2 import Gl2Conj, Gl2GemmRelin, \
    HEMatmul2
from matrix_fhe_tpu_torch.models.keyswitch import RelinContext

PRESET = "tiny"


def _message(p, seed):
    rng = np.random.default_rng(seed)
    W, n = p.phi, p.n
    return (rng.uniform(-2, 2, (W, n, n))
            + 1j * rng.uniform(-2, 2, (W, n, n)))


def _eq(got: torch.Tensor, want) -> None:
    np.testing.assert_array_equal(got.numpy().view(np.uint64), np.asarray(want))


@functools.lru_cache(maxsize=None)
def _jax_conj():
    """JAX tiny gl2 context, its key, X encrypted and Gl2Conj applied."""
    jp = jax_params(PRESET)
    jctx = JaxGl2Context(jp, use_pallas=False)
    jhm = JaxHEMatmul2(jctx)
    jrc = jks.RelinContext(jctx)
    X = _message(jp, 31)
    jsk = jctx.generate_secret_key(jax.random.key(1))
    jct = jctx.encrypt(jctx.encode(jnp.asarray(X.real), jnp.asarray(X.imag)),
                       jsk, jax.random.key(2))
    jcj = JaxGl2Conj(jhm, jrc, jsk, jax.random.key(34))
    return jhm, jrc, jsk, jct, jcj, jcj.apply(jct)


@pytest.fixture(scope="module")
def port():
    ctx = Gl2Context(get_params(PRESET), device="cpu")
    hm = HEMatmul2(ctx)
    return hm, RelinContext(ctx)


def test_sigma_s_target_matches_jax(port):
    """sigma(s) over QP, [Lqp, W, 2n]: the lane flip and the slot reversal
    of the gl2 X-NTT's 2n-point order, bit for bit with JAX's
    jnp.take(s_hat, flip, axis=1)[:, :, ::-1]."""
    hm, rc = port
    jhm, jrc, jsk, *_ = _jax_conj()
    s_res = np.asarray(jnp.asarray(
        jhm.ctx._ternary_residues(jsk.s_sign, jhm.ctx.params.moduli)))
    want = jnp.take(jrc._lift_ternary(jnp.asarray(s_res)), jhm._flip,
                    axis=1)[:, :, ::-1]
    got = Gl2Conj.sigma_s_hat(hm, rc, convert.secret_key2(jsk))
    assert got.shape == (len(rc.qp_moduli), hm.ctx.params.phi, hm.m)
    _eq(got, want)


def test_apply_on_jax_key_matches_jax(port):
    """The port's apply with the converted JAX switch key on the converted
    ciphertext == JAX Gl2Conj.apply, both components bit for bit; the
    input is left as it was."""
    hm, rc = port
    *_, jct, jcj, want = _jax_conj()
    cj = convert.gl2_conj(jcj, hm, rc)
    ct = convert.ciphertext2(jct)
    before = [x.clone() for x in ct]
    got = cj.apply(ct)
    _eq(got.b, want.b)
    _eq(got.a, want.a)
    assert all(torch.equal(x, y) for x, y in zip(ct, before))


def test_port_keyed_conjugation_decodes_to_conj(port):
    """A key from a torch.Generator: decrypt(apply(encrypt(X))) decodes to
    conj(X) within the JAX test's 0.5 at tiny; the key has dnum digits of
    [Lqp, W, n, 2n]; conjugating twice gives X back."""
    hm, rc = port
    ctx = hm.ctx
    p = ctx.params
    gen = torch.Generator().manual_seed(3)
    sk = ctx.generate_secret_key(gen)
    X = _message(p, 31)
    ct = ctx.encrypt(ctx.encode(torch.from_numpy(X.real),
                                torch.from_numpy(X.imag)), sk, gen)
    cj = Gl2Conj(hm, rc, sk, torch.Generator().manual_seed(34))
    assert len(cj._ksk.b) == rc.dnum
    assert cj._ksk.b[0].shape == (len(rc.qp_moduli), p.phi, p.n, 2 * p.n)
    ct_c = cj.apply(ct)
    dr, di = ctx.decrypt_and_decode(ct_c, sk)
    err = float(np.hypot(dr.numpy() - X.real, di.numpy() + X.imag).max())
    assert np.isfinite(err) and err < 0.5, f"conj error {err:.3e}"
    dr2, di2 = ctx.decrypt_and_decode(cj.apply(ct_c), sk)
    err2 = float(np.hypot(dr2.numpy() - X.real, di2.numpy() - X.imag).max())
    assert err2 < 0.5, f"double conj error {err2:.3e}"


def test_conj_shares_the_gemm_relin_context(port):
    """Gl2Conj takes the RelinContext of a Gl2GemmRelin (the same P basis
    and digits), as chip_smoke.py's path 4 builds it."""
    hm, _ = port
    gr = Gl2GemmRelin(hm)
    sk = hm.ctx.generate_secret_key(torch.Generator().manual_seed(1))
    cj = Gl2Conj(hm, gr.rc, sk, torch.Generator().manual_seed(2))
    assert cj.rc is gr.rc and len(cj._ksk.a) == gr.rc.dnum


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernels)")
    return torch.device("cuda")


@pytest.mark.cuda
def test_conjugation_on_the_card_equals_the_cpu(cuda, port):
    """A key and a ciphertext made on the CPU, conjugated on the card (K1,
    K10a's twiddle form) and on the CPU's plain path: the same bits."""
    from matrix_fhe_tpu_torch.models.he2 import Ciphertext2
    from matrix_fhe_tpu_torch.models.keyswitch import RelinKey

    hm, rc = port
    ctx = hm.ctx
    gen = torch.Generator().manual_seed(3)
    sk = ctx.generate_secret_key(gen)
    X = _message(ctx.params, 31)
    ct = ctx.encrypt(ctx.encode(torch.from_numpy(X.real),
                                torch.from_numpy(X.imag)), sk, gen)
    cj = Gl2Conj(hm, rc, sk, torch.Generator().manual_seed(34))
    want = cj.apply(ct)
    gctx = Gl2Context(ctx.params, device="cuda")
    ghm = HEMatmul2(gctx)
    key = RelinKey(*(tuple(k.cuda() for k in part) for part in cj._ksk))
    got = Gl2Conj.from_key(ghm, RelinContext(gctx), key).apply(
        Ciphertext2(*(t.cuda() for t in ct)))
    assert torch.equal(got.b.cpu(), want.b) and torch.equal(got.a.cpu(), want.a)
