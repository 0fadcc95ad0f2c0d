"""Port gl2 relinearization (BasisExtender, RelinContext, Gl2GemmRelin)
against the JAX package, and the port's own switch keys.

On the CPU every kernel runs its plain version.  Base conversions, the
key-switch constants, ModDown and the relinearized ciphertext on a
converted JAX GemmRelinKey must match bit for bit; the port's own keys
come from a torch.Generator and are held to the key equation and to the
JAX package's error bounds (tests/test_he_matmul2.py).
"""

import dataclasses
import functools
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_workers  # noqa: F401
from matrix_fhe_tpu.config import get_params as jax_params
from matrix_fhe_tpu.models import keyswitch as jks
from matrix_fhe_tpu.models.he2 import Gl2Context as JaxGl2Context
from matrix_fhe_tpu.models.he_matmul2 import Gl2GemmRelin as JaxGl2GemmRelin
from matrix_fhe_tpu.models.he_matmul2 import HEMatmul2 as JaxHEMatmul2
from matrix_fhe_tpu_torch import convert
from matrix_fhe_tpu_torch.config import get_params
from matrix_fhe_tpu_torch.models import keyswitch as tks
from matrix_fhe_tpu_torch.models.he2 import Gl2Context
from matrix_fhe_tpu_torch.models.he_matmul2 import Gl2GemmRelin, HEMatmul2
from matrix_fhe_tpu_torch.ops import modmath as tmm


def _residues(moduli, shape, seed):
    rng = np.random.default_rng(seed)
    return np.stack([rng.integers(0, int(q), size=shape, dtype=np.uint64)
                     for q in moduli])


def _i64(x) -> torch.Tensor:
    return convert.residues(x)


def _eq(got: torch.Tensor, want) -> None:
    np.testing.assert_array_equal(got.numpy().view(np.uint64), np.asarray(want))


def _messages(p, seed, scale=2.0):
    rng = np.random.default_rng(seed)
    W, n = p.phi, p.n
    return [rng.uniform(-scale, scale, (W, n, n))
            + 1j * rng.uniform(-scale, scale, (W, n, n)) for _ in range(2)]


def _err(pair, want) -> float:
    return float(np.hypot(pair[0].numpy() - want.real,
                          pair[1].numpy() - want.imag).max())


# -- basis extension and the key-switch constants ---------------------------------

@pytest.mark.parametrize("preset", ["tiny", "small", "mid", "ref"])
def test_default_p_moduli_match_jax(preset):
    jp, tp = jax_params(preset), get_params(preset)
    assert tks._default_p_moduli(tp) == jks._default_p_moduli(jp)
    auto_t = dataclasses.replace(tp, p_moduli=())
    auto_j = dataclasses.replace(jp, p_moduli=())
    assert tks._default_p_moduli(auto_t) == jks._default_p_moduli(auto_j)


@pytest.fixture(scope="module", params=["tiny", "small"])
def relin_ctx(request):
    """Both packages' RelinContext on the tiny and the small gl2 context."""
    jctx = JaxGl2Context(jax_params(request.param), use_pallas=False)
    return jks.RelinContext(jctx), tks.RelinContext(
        Gl2Context(get_params(request.param), device="cpu"))


def test_relin_context_constants_match_jax(relin_ctx):
    jrc, rc = relin_ctx
    assert rc.p_moduli == jrc.p_moduli and rc.groups == jrc.groups
    assert rc.dnum == jrc.dnum and rc.big_p == jrc.big_p
    assert (rc.y_dim, rc.x_dim) == (jrc.y_dim, jrc.x_dim)
    for g, w in zip(rc._g_consts, jrc._g_consts):
        np.testing.assert_array_equal(g, w)
    # the JAX P^-1 is kept in storage form (x 2^64)
    pinv = tmm.mul_mod(rc._moddown._div_inv.reshape(-1, 1, 1, 1),
                       tmm.moduli_col([(1 << 64) % q for q in rc.q_moduli],
                                      3, "cpu"), rc._q)
    _eq(pinv.reshape(-1), jrc._pinv_mont)


@pytest.mark.parametrize("which", ["group0", "group-last", "moddown"])
def test_basis_extender_matches_jax(relin_ctx, which):
    """scaled_residues (r' and the f64 quotient k), extend and
    extend_from(dst_slice) bit for bit."""
    jrc, rc = relin_ctx
    if which == "moddown":
        jext, ext = jrc._moddown, rc._moddown
    else:
        i = 0 if which == "group0" else len(rc.groups) - 1
        jext, ext = jrc._extenders[i], rc._extenders[i]
    x = _residues(ext.src, (8, 16, 16), 11)
    jrp, jk = jext.scaled_residues(jnp.asarray(x))
    rp, k = ext.scaled_residues(_i64(x))
    _eq(rp, jrp)
    np.testing.assert_array_equal(k.numpy(), np.asarray(jk).astype(np.int64))
    assert len(np.unique(k.numpy())) > 1
    _eq(ext.extend(_i64(x)), jext.extend(jnp.asarray(x)))
    lo, hi = 1, len(ext.dst) - 1
    _eq(ext.extend_from(rp, k, dst_slice=(lo, hi)),
        jext.extend_from(jrp, jk, dst_slice=(lo, hi)))


@pytest.mark.parametrize("group", [0, 1, 2, 3, "moddown"])
def test_basis_extender_ref_moduli_match_jax(group):
    """The same at the ref chain's groups (45/35-bit limbs to the 14-limb
    QP basis) and its ModDown (the 55 + 40 + 40-bit P to Q): the f64 sum
    in limb order gives XLA's k on every element."""
    from matrix_fhe_tpu.ops.rns_ext import BasisExtender as JaxExtender
    from matrix_fhe_tpu_torch.ops.rns_ext import BasisExtender

    p = get_params("ref")
    if group == "moddown":
        src, dst = p.p_moduli, p.moduli
    else:
        groups = tks._greedy_groups(p.moduli, tks._prod(p.p_moduli))
        assert len(groups) == 4
        src, dst = [p.moduli[l] for l in groups[group]], p.moduli + p.p_moduli
    x = _residues(src, (1 << 16,), 14)
    jrp, jk = JaxExtender(src, dst).scaled_residues(jnp.asarray(x))
    ext = BasisExtender(src, dst, "cpu")
    rp, k = ext.scaled_residues(_i64(x))
    np.testing.assert_array_equal(k.numpy(), np.asarray(jk).astype(np.int64))
    _eq(ext.extend_from(rp, k), JaxExtender(src, dst).extend_from(jrp, jk))


def test_lift_ternary_and_mod_down_match_jax(relin_ctx):
    jrc, rc = relin_ctx
    p = rc.ctx.params
    sign = np.random.default_rng(12).integers(-1, 2, (p.phi, 2 * p.n))
    s_res = Gl2Context._ternary_residues(torch.from_numpy(sign.astype(np.int8)),
                                         p.moduli)
    _eq(rc._lift_ternary(s_res), jrc._lift_ternary(np.asarray(
        s_res.numpy().view(np.uint64))))
    y = _residues(rc.qp_moduli, (p.phi, p.n, 2 * p.n), 13)
    _eq(rc._mod_down(_i64(y)), jrc._mod_down(jnp.asarray(y)))


# -- relinearization -----------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _jax_relin(preset):
    """JAX gl2 setup with its switch keys and GEMM tensor."""
    jp = jax_params(preset)
    jctx = JaxGl2Context(jp, use_pallas=False)
    jhm = JaxHEMatmul2(jctx)
    X, Y = _messages(jp, 31)
    jsk = jctx.generate_secret_key(jax.random.key(1))
    cts = [jctx.encrypt(jctx.encode(jnp.asarray(M.real), jnp.asarray(M.imag)),
                        jsk, jax.random.key(s)) for M, s in ((X, 2), (Y, 4))]
    jgr = JaxGl2GemmRelin(jhm)
    jks_ = jgr.gen_keys(jsk, jax.random.key(9))
    jtt = jhm.matmul_tensor(*cts)
    return jgr, jks_, jtt, jgr.relinearize_fn(jtt, jks_)


@pytest.mark.parametrize("preset,chunk_limbs",
                         [("tiny", 1), ("tiny", None), ("small", None)])
def test_relinearize_matches_jax(preset, chunk_limbs):
    """The port's limb-chunked relinearize on a converted JAX GemmRelinKey
    and tensor == JAX relinearize_fn, at 1-limb chunks (tiny) and one full
    chunk (tiny, small); its arguments are left as they were."""
    jgr, jkeys, jtt, want = _jax_relin(preset)
    gr = Gl2GemmRelin(HEMatmul2(Gl2Context(get_params(preset), device="cpu")),
                      chunk_limbs=chunk_limbs)
    if chunk_limbs == 1:
        assert len(gr._qp_chunks()) == len(gr.rc.qp_moduli)
    else:
        assert gr._qp_chunks() == [(0, len(gr.rc.qp_moduli))]
    tt = convert.gemm_tensor2(jtt)
    keys = convert.gemm_relin_key(jkeys)
    before = [x.clone() for x in tt]
    got = gr.relinearize(tt, keys)
    _eq(got.b, want.b)
    _eq(got.a, want.a)
    assert all(torch.equal(x, y) for x, y in zip(tt, before))


# -- the port's own keys ---------------------------------------------------------------

@pytest.fixture(scope="module")
def port_gemm():
    """Port-only tiny gl2 GEMM: keys from a torch.Generator, X and Y
    encrypted, switch keys at one full chunk and at 1-limb chunks."""
    p = get_params("tiny")
    ctx = Gl2Context(p, device="cpu")
    hm = HEMatmul2(ctx)
    gen = torch.Generator().manual_seed(1)
    sk = ctx.generate_secret_key(gen)
    X, Y = _messages(p, 31)
    cts = [ctx.encrypt(ctx.encode(torch.from_numpy(M.real),
                                  torch.from_numpy(M.imag)), sk, gen)
           for M in (X, Y)]
    gr = Gl2GemmRelin(hm)
    keys = gr.gen_keys(sk, torch.Generator().manual_seed(9))
    gr1 = Gl2GemmRelin(hm, gr.rc, chunk_limbs=1)
    keys1 = gr1.gen_keys(sk, torch.Generator().manual_seed(9))
    C = np.conj(np.swapaxes(Y, -1, -2)) @ X
    return types.SimpleNamespace(p=p, ctx=ctx, hm=hm, sk=sk, cts=cts, gr=gr,
                                 keys=keys, keys1=keys1, C=C)


def test_gen_keys_chunk_invariant(port_gemm):
    for part, part1 in zip(port_gemm.keys, port_gemm.keys1):
        assert len(part) == port_gemm.gr.rc.dnum
        for k, k1 in zip(part, part1):
            assert torch.equal(k, k1)


def test_switch_keys_satisfy_key_equation(port_gemm):
    """b + a (1(x)s) - g_i target opens through the inverse 2D NTT and
    W-CRT to a limb-consistent small Gaussian, |e| <= 8 sigma."""
    gr, rc = port_gemm.gr, port_gemm.gr.rc
    _, xntt, wt, q = gr._chunk_ctx(0, len(rc.qp_moduli))
    s_hat = rc._lift_ternary(Gl2Context._ternary_residues(
        port_gemm.sk.s_sign, port_gemm.p.moduli))
    ss_hat = s_hat.index_select(1, port_gemm.hm._flip).flip(-1)
    r_inv = tmm.moduli_col([pow(1 << 64, -1, int(x)) for x in rc.qp_moduli],
                           3, "cpu")
    targets = (ss_hat[:, :, :, None],
               tmm.mul_mod(ss_hat[:, :, :, None], s_hat[:, :, None, :], q))
    keys = port_gemm.keys
    for target, bs, as_ in ((targets[0], keys.b1, keys.a1),
                            (targets[1], keys.b2, keys.a2)):
        for i, (b, a) in enumerate(zip(bs, as_)):
            b, a = tmm.mul_mod(b, r_inv, q), tmm.mul_mod(a, r_inv, q)
            g = tmm.moduli_col(rc._g_consts[i].astype(np.int64).tolist(), 3,
                               "cpu")
            e_hat = tmm.sub_mod(
                tmm.add_mod(b, tmm.mul_mod(a, s_hat[:, :, None, :], q), q),
                tmm.mul_mod(g, target, q), q)
            e = wt.inverse(gr._intt2d(e_hat, xntt))
            e = torch.where(e > q // 2, e - q, e)
            assert (e == e[:1]).all(), "noise not limb-consistent"
            assert int(e.abs().max()) <= 8 * port_gemm.p.sigma
            assert int(e.abs().max()) > 0


def test_port_keyed_gemm_decodes_to_yhx(port_gemm):
    """encrypt -> tensor (K7) -> relinearize -> decrypt with the plain key
    -> Delta^2 decode == Y^H X within JAX's bound 2 base_err + 0.1, where
    base_err is the two-sided opening's error; then a GEMM of that GEMM
    stays within test_gemm_of_gemm_composes's bound."""
    pg = port_gemm
    d2 = float(pg.p.delta) ** 2
    tt = pg.hm.matmul_tensor(*pg.cts)
    base_err = _err(pg.ctx.decode(pg.hm.decrypt_tensor_fn(tt, pg.sk),
                                  delta_override=d2), pg.C)
    ctC = pg.gr.matmul(*pg.cts, pg.keys)
    assert ctC.b.shape == pg.cts[0].b.shape
    out = pg.ctx.decrypt_and_decode(ctC, pg.sk, delta_override=d2)
    assert all(np.isfinite(x.numpy()).all() for x in out)
    assert _err(out, pg.C) < 2 * base_err + 0.1
    ctD = pg.gr.matmul(ctC, ctC, pg.keys)
    D = np.conj(np.swapaxes(pg.C, -1, -2)) @ pg.C
    dd = pg.ctx.decrypt_and_decode(ctD, pg.sk, delta_override=d2 ** 2)
    assert _err(dd, D) / np.abs(D).max() < 0.05


def test_relin_context_refuses_the_folded_ring():
    from matrix_fhe_tpu_torch.models.he import HEContext
    with pytest.raises(ValueError, match="gl2"):
        tks.RelinContext(HEContext(get_params("tiny"), ring="gl",
                                   device="cpu"))
