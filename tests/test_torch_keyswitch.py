"""Port key switching (models/keyswitch.py and the rest of HEContext)
against the JAX package.

On the CPU every kernel runs its plain version.  With the JAX package's
keys carried across by matrix_fhe_tpu_torch.convert, every ciphertext,
key-switch correction and rescaled or rotated ciphertext must match the
JAX package bit for bit (the tolerance is 0: residues are exact).  The
port's own keys come from a torch.Generator and are held to the noise
bounds of tests/test_keyswitch.py.

At mid, the preset three examples run by default, RelinContext makes its
own P (six 28-bit limbs, dnum 1, one gadget group of all four Q limbs):
its constants, both base conversions (on random residues and on values at
the half-integer edge of the f64 quotient) and ModDown are held to JAX's on
narrow slices; the full mid multiply_relinearize is marked `slow`
(pytest -m slow tests/test_torch_keyswitch.py).
"""

import dataclasses
import functools
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from matrix_fhe_tpu.config import generate_ntt_primes
from matrix_fhe_tpu.config import get_params as jax_params
from matrix_fhe_tpu.models import keyswitch as jks
from matrix_fhe_tpu.models import rng as jrng
from matrix_fhe_tpu.models.he import HEContext as JaxContext
from matrix_fhe_tpu_torch import convert
from matrix_fhe_tpu_torch.config import get_params
from matrix_fhe_tpu_torch.models import keyswitch as tks
from matrix_fhe_tpu_torch.models import rng as trng
from matrix_fhe_tpu_torch.models.he import Ciphertext, HEContext
from matrix_fhe_tpu_torch.ops import modmath as tmm
from matrix_fhe_tpu_torch.utils.debug import composed_magnitude


def _eq(got: torch.Tensor, want) -> None:
    np.testing.assert_array_equal(got.numpy().view(np.uint64), np.asarray(want))


def _ct_eq(got: Ciphertext, want) -> None:
    _eq(got.b, want.b)
    _eq(got.a, want.a)


def _coeffs(p, seed, bits):
    """A limb-consistent small-coefficient element, W-coeff residues."""
    c = np.random.default_rng(seed).integers(0, 1 << bits,
                                             (p.phi, p.n, p.n))
    return np.stack([(c % int(q)).astype(np.uint64) for q in p.moduli])


def _explicit_p(p):
    """The 4-prime P basis of test_keyswitch.py's multi-digit case."""
    cand = [q for q in generate_ntt_primes(8, 34, p.n, p.p)
            if q not in p.moduli]
    return cand[:4]


@functools.lru_cache(maxsize=None)
def _setup(preset: str, explicit_p: bool = False):
    """Both packages' contexts over one preset, the JAX relinearization key
    (carried across), and two encrypted messages (their W-eval plaintexts
    too)."""
    jp, tp = jax_params(preset), get_params(preset)
    jctx = JaxContext(jp, ring="nega")
    ctx = HEContext(tp, ring="nega", device="cpu")
    p_moduli = _explicit_p(jp) if explicit_p else None
    jrc = jks.RelinContext(jctx, p_moduli=p_moduli)
    rc = tks.RelinContext(ctx, p_moduli=p_moduli)
    jsk = jctx.generate_secret_key()
    sk = ctx.generate_secret_key()
    jrlk = jrc.gen_relin_key(jnp.asarray(jrng.ternary_secret(jp)),
                             jax.random.key(5))
    ms = [np.asarray(jctx.wt.forward(jnp.asarray(_coeffs(jp, s, 14))))
          for s in (1, 2)]
    jcts = [jctx.encrypt(jnp.asarray(m), jsk) for m in ms]
    return types.SimpleNamespace(
        jp=jp, tp=tp, jctx=jctx, ctx=ctx, jrc=jrc, rc=rc, jsk=jsk, sk=sk,
        jrlk=jrlk, rlk=convert.relin_key(jrlk), ms=ms, jcts=jcts,
        cts=[convert.ciphertext(c) for c in jcts])


# -- the rest of HEContext ----------------------------------------------------------

@pytest.mark.parametrize("op", ["encrypt", "decrypt_to_eval", "add_ciphertexts",
                                "multiply_ciphertexts_raw", "multiply_plain",
                                "add_plain"])
def test_he_context_ops_match_jax(op):
    s = _setup("tiny")
    m = convert.residues(s.ms[0])
    if op == "encrypt":
        _ct_eq(s.ctx.encrypt(m, s.sk), s.jcts[0])
        assert torch.equal(s.sk.s_mont, convert.secret_key(s.jsk).s_mont)
    elif op == "decrypt_to_eval":
        got = s.ctx.decrypt_to_eval(s.cts[0], s.sk)
        _eq(got, s.jctx.decrypt_to_eval(s.jcts[0], s.jsk))
    elif op == "add_ciphertexts":
        _ct_eq(s.ctx.add_ciphertexts(*s.cts), s.jctx.add_ciphertexts(*s.jcts))
    elif op == "multiply_ciphertexts_raw":
        for g, w in zip(s.ctx.multiply_ciphertexts_raw(*s.cts),
                        s.jctx.multiply_ciphertexts_raw(*s.jcts)):
            _eq(g, w)
    elif op == "multiply_plain":
        m2 = s.ms[1]
        _ct_eq(s.ctx.multiply_plain(s.cts[0], convert.residues(m2)),
               s.jctx.multiply_plain(s.jcts[0], m2))
    else:
        _ct_eq(s.ctx.add_plain(s.cts[0], convert.residues(s.ms[1])),
               s.jctx.add_plain(s.jcts[0], s.ms[1]))


def test_encrypt_leaves_its_arguments():
    s = _setup("tiny")
    m = convert.residues(s.ms[0])
    before = (m.clone(), s.sk.s_mont.clone())
    ct = s.ctx.encrypt(m, s.sk)
    s.ctx.multiply_plain(ct, m)
    assert torch.equal(m, before[0]) and torch.equal(s.sk.s_mont, before[1])


# -- RelinContext -----------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _relin_pair(preset: str, p_moduli):
    """Both packages' RelinContext over one preset's "nega" context, with
    p_moduli None, "auto" or "explicit" (_explicit_p)."""
    jp, tp = jax_params(preset), get_params(preset)
    arg = _explicit_p(jp) if p_moduli == "explicit" else p_moduli
    return (jks.RelinContext(JaxContext(jp, ring="nega"), p_moduli=arg),
            tks.RelinContext(HEContext(tp, ring="nega", device="cpu"),
                             p_moduli=arg))


@pytest.mark.parametrize("preset,p_moduli", [("tiny", None), ("tiny", "auto"),
                                             ("tiny", "explicit"),
                                             ("small", "explicit"),
                                             ("mid", None), ("mid", "auto")])
def test_relin_context_constants_match_jax(preset, p_moduli):
    """RelinContext(ctx, p_moduli=None | "auto" | primes): the P basis,
    groups, dnum, gadget constants and P^-1 as keyswitch.py:148-155 makes
    them (at ref, _default_p_moduli is compared in
    test_torch_gl2_relin.py).  mid pins no P, so None and "auto" both run
    the search: six 28-bit limbs and one group of all four Q limbs."""
    jrc, rc = _relin_pair(preset, p_moduli)
    if preset == "mid":
        assert [q.bit_length() for q in rc.p_moduli] == [28] * 6
        assert rc.groups == [(0, 1, 2, 3)] and rc.dnum == 1
    assert rc.p_moduli == jrc.p_moduli and rc.groups == jrc.groups
    assert rc.dnum == jrc.dnum and rc.big_p == jrc.big_p
    assert rc.qp_moduli == jrc.qp_moduli
    for g, w in zip(rc._g_consts, jrc._g_consts):
        np.testing.assert_array_equal(g, w)
    pinv = tmm.mul_mod(rc._pinv, tmm.moduli_col(
        [(1 << 64) % q for q in rc.q_moduli], 3, "cpu"), rc._q)
    _eq(pinv.reshape(-1), jrc._pinv_mont)


# -- mid's base conversions and ModDown, on narrow slices ---------------------------------

def _residues(moduli, shape, seed):
    rng = np.random.default_rng(seed)
    return np.stack([rng.integers(0, int(q), size=shape, dtype=np.uint64)
                     for q in moduli])


EDGE = 2048


def _edge_residues(moduli):
    """Residues of M // 2 + d, M // 3 + d, M // 4 + d, d and M - 1 - d
    (mod M) for |d| <= EDGE, M = prod(moduli): the f64 quotient
    sum_l r'_l / q_l = K + x / M sits at a half-integer near M / 2, so its
    rounding decides the representative there. [Ls, 5, 2 EDGE + 1]."""
    big_m = tks._prod(int(q) for q in moduli)
    ds = range(-EDGE, EDGE + 1)
    vals = [[(c + d) % big_m for d in ds]
            for c in (big_m // 2, big_m // 3, big_m // 4, 0)]
    vals.append([(big_m - 1 - d) % big_m for d in ds])
    return np.array([[[v % int(q) for v in row] for row in vals]
                     for q in moduli], dtype=np.uint64)


@pytest.mark.parametrize("inputs", ["random", "edge"])
@pytest.mark.parametrize("which", ["keyswitch", "moddown"])
def test_mid_basis_extender_matches_jax(which, inputs):
    """mid's two base conversions, the digit's 4 Q -> QP (its 6 P limbs)
    and ModDown's 6 P -> 4 Q: scaled_residues (r' and the f64 quotient k),
    extend, and extend / extend_from in dst_slice chunks of two limbs, bit
    for bit with JAX's, on random residues [Ls, 8, 64, 64] (one W block of
    the [L, 512, 64, 64] ciphertext: both sides are elementwise over the
    trailing axes) and on the half-integer edge of k for M = Q and M = P."""
    jrc, rc = _relin_pair("mid", None)
    if which == "keyswitch":
        jext, ext = jrc._extenders[0], rc._extenders[0]
        assert ext.src == rc.q_moduli and ext.dst == rc.qp_moduli
    else:
        jext, ext = jrc._moddown, rc._moddown
        assert ext.src == rc.p_moduli and ext.dst == rc.q_moduli
    x = (_residues(ext.src, (8, 64, 64), 21) if inputs == "random"
         else _edge_residues(ext.src))
    jrp, jk = jext.scaled_residues(jnp.asarray(x))
    rp, k = ext.scaled_residues(convert.residues(x))
    _eq(rp, jrp)
    np.testing.assert_array_equal(k.numpy(), np.asarray(jk).astype(np.int64))
    assert len(np.unique(k.numpy())) > 1
    full = ext.extend(convert.residues(x))
    _eq(full, jext.extend(jnp.asarray(x)))
    for lo in range(0, len(ext.dst), 2):
        hi = min(lo + 2, len(ext.dst))
        chunk = ext.extend_from(rp, k, dst_slice=(lo, hi))
        _eq(chunk, jext.extend_from(jrp, jk, dst_slice=(lo, hi)))
        _eq(ext.extend(convert.residues(x), dst_slice=(lo, hi)),
            jext.extend(jnp.asarray(x), dst_slice=(lo, hi)))
        assert torch.equal(chunk, full[lo:hi])


@pytest.mark.parametrize("which", ["keyswitch", "moddown"])
def test_mid_edge_values_extend_to_a_bounded_representative(which):
    """Each edge value x extends to x or x - M, the two representatives
    |x~| <= M allows, on every target limb at once; in the M // 2 window,
    where the f64 sum is K + 1/2 to the last bit, both occur (the rounding
    goes by K's parity), so the window does exercise the tie."""
    _, rc = _relin_pair("mid", None)
    ext = rc._extenders[0] if which == "keyswitch" else rc._moddown
    got = ext.extend(convert.residues(_edge_residues(ext.src))).numpy()
    got = got.view(np.uint64).reshape(len(ext.dst), -1)
    big_m = tks._prod(ext.src)
    ds = range(-EDGE, EDGE + 1)
    vals = [(c + d) % big_m for c in (big_m // 2, big_m // 3, big_m // 4, 0)
            for d in ds] + [(big_m - 1 - d) % big_m for d in ds]
    shifted = []
    for i, v in enumerate(vals):
        col = [int(r) for r in got[:, i]]
        low = [v % q for q in ext.dst]
        high = [(v - big_m) % q for q in ext.dst]
        assert col in (low, high), (i, v)
        shifted.append(col == high and col != low)
    assert 0 < sum(shifted[:len(ds)]) < len(ds)


def test_mid_mod_down_matches_jax():
    """RelinContext._mod_down at mid (6 P limbs down to 4 Q) on a narrow
    [Lqp, 8, 64, 64] slice, bit for bit with JAX's."""
    jrc, rc = _relin_pair("mid", None)
    y = _residues(rc.qp_moduli, (8, 64, 64), 22)
    _eq(rc._mod_down(convert.residues(y)), jrc._mod_down(jnp.asarray(y)))


def test_relin_context_rejects_a_bad_basis_name():
    s = _setup("tiny")
    with pytest.raises(ValueError, match="auto"):
        tks.RelinContext(s.ctx, p_moduli="preset")


# -- the switch on JAX keys ------------------------------------------------------------

def test_key_switch_d2_matches_jax():
    s = _setup("tiny")
    d2 = np.stack([np.random.default_rng(3).integers(
        0, int(q), (s.jp.phi, s.jp.n, s.jp.n), dtype=np.uint64)
        for q in s.jp.moduli])
    want = s.jrc.key_switch_d2(jnp.asarray(d2), s.jrlk)
    got = s.rc.key_switch_d2(convert.residues(d2), s.rlk)
    _eq(got[0], want[0])
    _eq(got[1], want[1])


@pytest.mark.parametrize("preset,explicit_p", [("tiny", False),
                                               ("small", True)])
def test_multiply_relinearize_matches_jax_fused_and_streamed(preset,
                                                             explicit_p):
    """The port's one route == JAX fused == JAX streamed, at tiny and at a
    dnum >= 2 gadget at small; the arguments are left as they were."""
    s = _setup(preset, explicit_p)
    if explicit_p:
        assert s.rc.dnum >= 2
    fused = s.jrc.multiply_relinearize(*s.jcts, s.jrlk)
    streamed = s.jrc.multiply_relinearize_streamed(*s.jcts, s.jrlk)
    before = [t.clone() for ct in s.cts for t in ct]
    got = s.rc.multiply_relinearize(*s.cts, s.rlk)
    _ct_eq(got, fused)
    _ct_eq(got, streamed)
    assert all(torch.equal(t, b) for t, b in
               zip((t for ct in s.cts for t in ct), before))
    _ct_eq(s.rc.multiply_relinearize_streamed(*s.cts, s.rlk), fused)


@pytest.mark.slow
def test_mid_multiply_relinearize_matches_jax():
    """The full mid multiply_relinearize (dnum 1, six 28-bit P limbs) on a
    converted JAX key against JAX's fused result, bit for bit (several
    minutes on one CPU worker: pytest -m slow)."""
    s = _setup("mid")
    assert s.rc.dnum == 1 and len(s.rc.p_moduli) == 6
    _ct_eq(s.rc.multiply_relinearize(*s.cts, s.rlk),
           s.jrc.multiply_relinearize(*s.jcts, s.jrlk))


def test_multiply_relinearize_pair_matches_jax():
    s = _setup("tiny")
    j3, j4 = (s.jctx.encrypt(s.jctx.wt.forward(jnp.asarray(
        _coeffs(s.jp, seed, 12))), s.jsk) for seed in (3, 4))
    want = s.jrc.multiply_relinearize_pair(s.jcts[0], s.jcts[1], j3, j4,
                                           s.jrlk)
    got = s.rc.multiply_relinearize_pair(
        s.cts[0], s.cts[1], convert.ciphertext(j3), convert.ciphertext(j4),
        s.rlk)
    for g, w in zip(got, want):
        _ct_eq(g, w)


@pytest.mark.parametrize("explicit", [False, True])
def test_rescale_ciphertext_matches_jax(explicit):
    """Both paths: the cached pipeline (reduced-chain transform built once
    per context) and the explicit Rescaler (zero-padded full chain)."""
    s = _setup("tiny")
    prod = s.jrc.multiply_relinearize(*s.jcts, s.jrlk)
    jrs = jks.Rescaler(s.jp.moduli) if explicit else None
    rs = tks.Rescaler(s.tp.moduli, "cpu") if explicit else None
    want = jks.rescale_ciphertext(s.jctx, prod, jrs)
    got = tks.rescale_ciphertext(s.ctx, convert.ciphertext(prod), rs)
    assert got.b.shape[0] == len(s.tp.moduli) - 1
    _ct_eq(got, want)
    if not explicit:
        assert tks._rescale_pipeline(s.ctx) is tks._rescale_pipeline(s.ctx)


# -- Galois keys on JAX keys -------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _jax_full_galois():
    s = _setup("tiny")
    fk = jks.FullGaloisKeys(s.jrc, jnp.asarray(jrng.ternary_secret(s.jp)),
                            jax.random.key(51))
    return fk, convert.full_galois_keys(fk, s.rc)


def test_w_automorphism_perm_matches_jax():
    p = get_params("small")
    for j in range(1, p.p):
        if np.gcd(j, p.p) == 1:
            np.testing.assert_array_equal(
                tks.w_automorphism_perm(p, j),
                jks.w_automorphism_perm(jax_params("small"), j))


def test_galois_keys_apply_matches_jax():
    s = _setup("tiny")
    j = 2
    jgk = jks.GaloisKeys(s.jrc, jnp.asarray(jrng.ternary_secret(s.jp)), [j],
                         jax.random.key(8))
    gk = convert.galois_keys(jgk, s.rc)
    _ct_eq(gk.apply(s.cts[0], j), jgk.apply(s.jcts[0], j))


def test_full_galois_keys_apply_every_unit_matches_jax():
    s = _setup("tiny")
    jfk, fk = _jax_full_galois()
    assert fk.indices == [jfk._t_idx] + jfk._g_idx
    units = [j for j in range(1, s.jp.p) if np.gcd(j, s.jp.p) == 1]
    assert len(units) == s.jp.phi
    for j in units:
        assert fk.decompose(j) == jfk.decompose(j)
        _ct_eq(fk.apply(s.cts[0], j), jfk.apply(s.jcts[0], j))


def test_slot_sum_matches_jax():
    s = _setup("tiny")
    jfk, fk = _jax_full_galois()
    _ct_eq(fk.slot_sum(s.cts[1]), jfk.slot_sum(s.jcts[1]))


def test_full_galois_group_tables_match_jax():
    for p in (15, 51, 771):
        assert tks.FullGaloisKeys.group_tables(p) == \
            jks.FullGaloisKeys.group_tables(p)


def test_x_galois_keys_apply_matches_jax():
    s = _setup("tiny")
    k = 3
    jxg = jks.XGaloisKeys(s.jrc, jnp.asarray(jrng.ternary_secret(s.jp)), [k],
                          jax.random.key(13))
    xg = convert.x_galois_keys(jxg, s.rc)
    _ct_eq(xg.apply(s.cts[0], k), jxg.apply(s.jcts[0], k))
    for kk in (1, 3, 5, 7, -1):
        for g, w in zip(tks.x_automorphism_maps(16, kk),
                        jks.x_automorphism_maps(16, kk)):
            np.testing.assert_array_equal(g, w)


def test_x_galois_keys_refuse_non_automorphisms_on_gl2():
    from matrix_fhe_tpu_torch.models.he2 import Gl2Context
    ctx = Gl2Context(get_params("tiny"), device="cpu")
    rc = tks.RelinContext(ctx)
    s_res = Gl2Context._ternary_residues(
        torch.zeros((ctx.params.phi, ctx.m), dtype=torch.int8),
        ctx.params.moduli)
    with pytest.raises(ValueError, match="1 mod 4"):
        tks.XGaloisKeys(rc, s_res, [3], torch.Generator().manual_seed(0))


# -- the port's own keys against the JAX tests' noise bounds -------------------------

@functools.lru_cache(maxsize=None)
def _own():
    """Port-only tiny setup: relinearization key from a torch.Generator."""
    p = get_params("tiny")
    ctx = HEContext(p, ring="nega", device="cpu")
    rc = tks.RelinContext(ctx)
    s_coeff = trng.ternary_secret(p, "cpu")
    sk = ctx.generate_secret_key()
    rlk = rc.gen_relin_key(s_coeff, torch.Generator().manual_seed(5))
    return types.SimpleNamespace(p=p, ctx=ctx, rc=rc, s_coeff=s_coeff, sk=sk,
                                 rlk=rlk)


def _enc(o, seed, bits=20):
    return o.ctx.encrypt(convert.residues(_coeffs(o.p, seed, bits)), o.sk)


def _ring_mul(ctx, a, b):
    xn = ctx.xntt
    return xn.inverse(xn.forward_mul(b, xn.forward_mul(a, ctx._r2_tw)))


def test_own_relin_key_satisfies_the_key_equation():
    """b + a s - g_i s^2 opens to a limb-consistent Gaussian, |e| <= 8
    sigma, with digits drawn in the JAX order (a, then e, per digit)."""
    o = _own()
    rc = o.rc
    assert len(o.rlk.b) == rc.dnum
    q = rc._qqp
    s_hat = rc._lift_ternary(o.s_coeff)
    r_inv = tmm.moduli_col([pow(1 << 64, -1, int(m)) for m in rc.qp_moduli],
                           3, "cpu")
    for i, (b, a) in enumerate(zip(o.rlk.b, o.rlk.a)):
        b, a = tmm.mul_mod(b, r_inv, q), tmm.mul_mod(a, r_inv, q)
        g = tmm.moduli_col(rc._g_consts[i].astype(np.int64).tolist(), 3, "cpu")
        s2 = tmm.mul_mod(s_hat, s_hat, q[..., 0])[:, :, None, :]
        e_hat = tmm.sub_mod(tmm.add_mod(b, tmm.mul_mod(a, s_hat[:, :, None],
                                                       q), q),
                            tmm.mul_mod(g, s2, q), q)
        e = rc.wt_qp.inverse(rc.xntt_qp.inverse(e_hat))
        e = torch.where(e > q // 2, e - q, e)
        assert (e == e[:1]).all(), "noise not limb-consistent"
        assert 0 < int(e.abs().max()) <= 8 * o.p.sigma


def test_own_key_switch_identity():
    """kb + ka s == d2 s^2 up to key-switch noise (test_keyswitch.py:60)."""
    o = _own()
    d2 = convert.residues(np.stack([np.random.default_rng(7).integers(
        0, int(q), (o.p.phi, o.p.n, o.p.n), dtype=np.uint64)
        for q in o.p.moduli]))
    kb, ka = o.rc.key_switch_d2(d2, o.rlk)
    xn, q = o.ctx.xntt, o.ctx._q4
    lhs = tmm.add_mod(kb, xn.mul_s(ka, o.sk.s_mont), q)
    rhs = xn.mul_s(xn.mul_s(d2, o.sk.s_mont), o.sk.s_mont)
    assert composed_magnitude(o.ctx, tmm.sub_mod(lhs, rhs, q)) < 10_000


def test_own_multiply_relinearize_end_to_end():
    """Decrypts to the ring product of the plaintexts within
    test_keyswitch.py:94's bound."""
    o = _own()
    ct1, ct2 = _enc(o, 21), _enc(o, 22)
    ct = o.rc.multiply_relinearize(ct1, ct2, o.rlk)
    assert ct.b.shape == ct1.b.shape
    got = o.ctx.decrypt_to_eval(ct, o.sk)
    want = _ring_mul(o.ctx, o.ctx.decrypt_to_eval(ct1, o.sk),
                     o.ctx.decrypt_to_eval(ct2, o.sk))
    assert composed_magnitude(o.ctx, tmm.sub_mod(got, want, o.ctx._q4)) \
        < 100_000


def test_own_rekey_switch():
    """A switch key for an old secret moves a ciphertext to s."""
    o = _own()
    gen = torch.Generator().manual_seed(77)
    sk_old = o.ctx.generate_secret_key(gen)
    s_old = trng.fresh_ternary_secret(torch.Generator().manual_seed(77), o.p,
                                      "cpu")
    ct = o.ctx.encrypt(convert.residues(_coeffs(o.p, 23, 20)), sk_old)
    swk = o.rc.gen_switch_key(o.rc._lift_ternary(s_old), o.s_coeff,
                              torch.Generator().manual_seed(6))
    kb, ka = o.rc.key_switch_d2(ct.a, swk)
    ct_new = Ciphertext(b=tmm.add_mod(ct.b, kb, o.ctx._q4), a=ka)
    diff = tmm.sub_mod(o.ctx.decrypt_to_eval(ct_new, o.sk),
                       o.ctx.decrypt_to_eval(ct, sk_old), o.ctx._q4)
    assert composed_magnitude(o.ctx, diff) < 10_000


def test_own_full_galois_every_rotation_and_slot_sum():
    """Every unit rotation within test_keyswitch.py:607's bound, and
    slot_sum within :683's."""
    o = _own()
    fk = tks.FullGaloisKeys(o.rc, o.s_coeff, torch.Generator().manual_seed(51))
    assert len(fk._gk._keys) <= 2 + (o.p.p // 3 - 2).bit_length()
    ct = _enc(o, 24)
    plain = o.ctx.decrypt_to_eval(ct, o.sk)
    q = o.ctx._q4
    for j in [j for j in range(1, o.p.p) if np.gcd(j, o.p.p) == 1]:
        got = o.ctx.decrypt_to_eval(fk.apply(ct, j), o.sk)
        perm = torch.from_numpy(tks.w_automorphism_perm(o.p, j))
        assert composed_magnitude(o.ctx, tmm.sub_mod(got, plain[:, perm], q)) \
            < 100_000, j
    ct = _enc(o, 25, 18)
    plain = o.ctx.decrypt_to_eval(ct, o.sk)
    got = o.ctx.decrypt_to_eval(fk.slot_sum(ct), o.sk)
    lane_sum = plain[:, :1]
    for w in range(1, o.p.phi):
        lane_sum = tmm.add_mod(lane_sum, plain[:, w:w + 1], q)
    diff = tmm.sub_mod(got, lane_sum.expand_as(plain), q)
    assert composed_magnitude(o.ctx, diff) < 1_000_000


def test_own_x_galois_and_complex_pair():
    """X -> X^3 within test_keyswitch.py:358's bound; the Gaussian-pair
    product within :577's."""
    o = _own()
    xg = tks.XGaloisKeys(o.rc, o.s_coeff, [3], torch.Generator().manual_seed(13))
    ct = _enc(o, 26)
    got = o.ctx.decrypt_to_eval(xg.apply(ct, 3), o.sk)
    gi, sg, _ = tks.x_automorphism_maps(o.p.n, 3)
    plain = o.ctx.decrypt_to_eval(ct, o.sk)
    t = plain[..., torch.from_numpy(gi)]
    want = torch.where(torch.from_numpy(sg < 0), tmm.neg_mod(t, o.ctx._q4), t)
    assert composed_magnitude(o.ctx, tmm.sub_mod(got, want, o.ctx._q4)) \
        < 10_000

    def enc16(seed):
        return o.ctx.encrypt(o.ctx.wt.forward(convert.residues(
            _coeffs(o.p, seed, 16))), o.sk)

    r1, i1, r2, i2 = (enc16(s) for s in (31, 32, 33, 34))
    outr, outi = o.rc.multiply_relinearize_pair(r1, i1, r2, i2, o.rlk)
    q = o.ctx._q4
    dec = [o.ctx.decrypt_to_eval(c, o.sk) for c in (r1, i1, r2, i2)]
    want_r = tmm.sub_mod(_ring_mul(o.ctx, dec[0], dec[2]),
                         _ring_mul(o.ctx, dec[1], dec[3]), q)
    want_i = tmm.add_mod(_ring_mul(o.ctx, dec[0], dec[3]),
                         _ring_mul(o.ctx, dec[1], dec[2]), q)
    for got, want in ((outr, want_r), (outi, want_i)):
        diff = tmm.sub_mod(o.ctx.decrypt_to_eval(got, o.sk), want, q)
        assert composed_magnitude(o.ctx, diff) < 1 << 36


def test_own_rescale_divides_by_the_last_prime():
    """ct' decrypts to round(m / q_last) within test_keyswitch.py:196's
    slop (<= 64), measured with the exact composer."""
    o = _own()
    ct = o.ctx.encrypt(o.ctx.wt.forward(convert.residues(
        _coeffs(o.p, 27, 55))), o.sk)
    ct2 = tks.rescale_ciphertext(o.ctx, ct)
    p_red = dataclasses.replace(o.p, name=o.p.name + "-red",
                                moduli=o.p.moduli[:-1])
    ctx2 = HEContext(p_red, device="cpu")
    got = ctx2.decrypt_to_eval(ct2, type(o.sk)(o.sk.s_mont[:-1]))
    comp = o.ctx.wt.composer
    full = comp.compose_centered_i64(o.ctx.wt.inverse(
        o.ctx.decrypt_to_eval(ct, o.sk)))
    q_last = int(o.p.moduli[-1])
    want = torch.div(full + q_last // 2, q_last, rounding_mode="floor")
    got_i = ctx2.wt.composer.compose_centered_i64(ctx2.wt.inverse(got))
    assert int(want.abs().max()) > 1 << 20
    assert int((got_i - want).abs().max()) <= 64
